"""Primary-ray generation (the reference's K1, generate_rays.wgsl:42-91).

Vectorized over a flat pixel-index array; one (pixel, frame, sample)
RNG stream drives the AA jitter and thin-lens defocus draws.

Deviation from the reference (deliberate, SURVEY.md §8 bug 3): ray
directions here are always unit length — the reference leaves *bounce*
directions unnormalized and its sky gradient then uses a raw ``dir.y``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops import rng
from wavefront_path_tracer_tpu.scene.camera import GPUCamera

RAYGEN_STREAM = 0  # bounce-slot 0 of the per-event RNG streams


def _apply_mat(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Row-vectors-through-matrix at full f32 precision.

    At default precision XLA may run a float32 matmul as TF32 on the
    GPU's tensor cores (10-bit mantissa); the unprojection's w-component
    is a near-cancellation (-1/(r*zn) + 1/zn ~= 1/zf) that reduced
    precision can round to exactly 0 -> inf rays.  These are
    (N,3|4)x(4,4) products, so full precision costs nothing measurable.
    """
    return jnp.einsum("nk,jk->nj", v, m, precision=jax.lax.Precision.HIGHEST)


def generate_rays(
    pixel_idx: jnp.ndarray,
    width: int,
    height: int,
    frame,
    sample,
    cam: GPUCamera,
    view: jnp.ndarray,      # (4, 4) world-from-camera
    inv_proj: jnp.ndarray,  # (4, 4) inverse projection
    sampler: str = "random",
):
    """Returns (origin (N,3), direction (N,3) unit).

    ``sampler='stratified'`` remaps the two AA-disk uniforms onto a 4x4
    stratum grid cycling with the sample index (sample & 3, sample >> 2
    & 3) — same draw COUNT and stream positions as 'random', so lens
    draws and every downstream stream are untouched; unbiased (each
    stratum is uniform) with lower pixel variance at low spp.
    """
    f32 = jnp.float32
    x = (pixel_idx % width).astype(f32)
    y = (pixel_idx // width).astype(f32)

    state = rng.stream_state(pixel_idx, frame, sample, RAYGEN_STREAM)
    if sampler == "stratified":
        state, u1 = rng.next_f32(state)
        state, u2 = rng.next_f32(state)
        s = jnp.asarray(sample, jnp.uint32)
        u1 = ((s & 3).astype(f32) + u1) * f32(0.25)
        u2 = (((s >> 2) & 3).astype(f32) + u2) * f32(0.25)
        r_aa = jnp.sqrt(u1)
        alpha = f32(2.0) * f32(3.1415927) * u2
        ox, oy = r_aa * jnp.cos(alpha), r_aa * jnp.sin(alpha)
    else:
        state, ox, oy = rng.sample_unit_disk(state)

    # NDC with y flipped (generate_rays.wgsl:66-67).
    ndc_x = 2.0 * ((x + ox) / f32(width)) - 1.0
    ndc_y = 2.0 * (1.0 - (y + oy) / f32(height)) - 1.0

    # Unproject: inv_proj @ (ndc, 1, 1), divide by w (wgsl:68-69).
    ones = jnp.ones_like(ndc_x)
    ndc4 = jnp.stack([ndc_x, ndc_y, ones, ones], axis=-1)  # (N, 4)
    pp = _apply_mat(inv_proj, ndc4)
    pp = pp[..., :3] / pp[..., 3:4]

    cam_pos = jnp.asarray(cam.position, f32)

    if cam.defocus_radius > 0.0:
        # Thin-lens: jitter the origin on the lens disk, retarget through
        # the focal plane (wgsl:73-82).
        state, lx, ly = rng.sample_unit_disk(state)
        p_lens = jnp.stack(
            [cam.defocus_radius * lx, cam.defocus_radius * ly, jnp.zeros_like(lx)],
            axis=-1,
        )
        origin = _apply_mat(view[:3, :3], p_lens) + view[:3, 3]
        tf = cam.focus_distance / pp[..., 2:3]
        pp = tf * pp - p_lens
    else:
        origin = jnp.broadcast_to(cam_pos, pp.shape)

    d = _apply_mat(view[:3, :3], pp)
    direction = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return origin, direction
