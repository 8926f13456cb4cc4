"""Ray-scene intersection (the reference's K2, extend.wgsl:72-210).

Wavefront formulation: instead of one SIMT thread per ray walking
spheres, we intersect a whole ray wavefront against sphere *blocks* with
dense (rays x spheres) vector math that XLA fuses.  The per-pair closest-t selection is
order-independent (see ``_sphere_hit_t``), so results match the
reference's sequential nearest-hit loop exactly.

Two intersectors:

* ``intersect_bruteforce`` — scans all spheres in fixed-size blocks via
  ``lax.scan`` (bounds memory to rays x block).  Equivalent to the
  reference's ``USE_BVH=false`` path (extend.wgsl:141-153).
* BVH traversal lives in ``ops/bvh_traverse.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

T_MIN = jnp.float32(0.001)   # shadow epsilon (extend.wgsl:90,148)
T_FAR = jnp.float32(1e30)    # 'no hit' sentinel (extend.wgsl:76)


def _sphere_hit_t(origin, direction, centers, radii):
    """Closest valid hit parameter per (ray, sphere) pair, or T_FAR.

    origin/direction: (N, 3); centers: (B, 3); radii: (B,).
    Returns (N, B) float32.

    Mirrors the reference's quadratic (extend.wgsl:185-210): prefer the
    near root if ``t > T_MIN``, else the far root (entering vs. exiting
    hits — the far root is what makes dielectric interiors work).  The
    reference also tests ``t < t_nearest`` per candidate, but since
    ``t1 <= t2`` the running-nearest test never changes which root wins,
    only whether a worse sphere is skipped — and the global min below
    subsumes that.  Hence this vectorized form is exactly equivalent to
    the sequential loop.
    """
    oc = origin[:, None, :] - centers[None, :, :]          # (N, B, 3)
    a = jnp.sum(direction * direction, axis=-1)[:, None]   # (N, 1)
    b = jnp.sum(direction[:, None, :] * oc, axis=-1)       # (N, B)
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    t = jnp.where(t1 > T_MIN, t1, jnp.where(t2 > T_MIN, t2, T_FAR))
    # r == 0 marks padding; NEGATIVE radii are real inside-out spheres
    # (the RTIOW hollow-bubble modeling trick: same geometry as |r|,
    # normal flipped in hit resolution) and must intersect like any
    # other — the quadratic only sees r*r.
    valid = (disc >= 0.0) & (radii[None, :] != 0.0)
    return jnp.where(valid, t, T_FAR)


@functools.partial(jax.jit, static_argnames=("sphere_chunk",))
def intersect_bruteforce(origin, direction, centers, radii, sphere_chunk: int = 128):
    """Nearest hit over all spheres.

    Returns (t (N,), sphere_idx (N,) int32, hit (N,) bool).  Spheres are
    processed in blocks of ``sphere_chunk`` (padded with degenerate
    spheres) so peak memory is rays x chunk, not rays x scene.
    """
    n_spheres = centers.shape[0]
    pad = (-n_spheres) % sphere_chunk
    if pad:
        # Zero-radius padding spheres are rejected inside _sphere_hit_t.
        centers = jnp.concatenate([centers, jnp.zeros((pad, 3), centers.dtype)])
        radii = jnp.concatenate([radii, jnp.zeros((pad,), radii.dtype)])
    n_blocks = centers.shape[0] // sphere_chunk
    centers_b = centers.reshape(n_blocks, sphere_chunk, 3)
    radii_b = radii.reshape(n_blocks, sphere_chunk)

    def scan_body(carry, block):
        best_t, best_idx = carry
        blk_centers, blk_radii, blk_base = block
        t = _sphere_hit_t(origin, direction, blk_centers, blk_radii)  # (N, B)
        blk_arg = jnp.argmin(t, axis=-1)
        blk_t = jnp.take_along_axis(t, blk_arg[:, None], axis=-1)[:, 0]
        better = blk_t < best_t
        best_idx = jnp.where(better, blk_base + blk_arg.astype(jnp.int32), best_idx)
        best_t = jnp.where(better, blk_t, best_t)
        return (best_t, best_idx), None

    n_rays = origin.shape[0]
    init = (jnp.full((n_rays,), T_FAR), jnp.zeros((n_rays,), jnp.int32))
    bases = (jnp.arange(n_blocks, dtype=jnp.int32) * sphere_chunk)
    (best_t, best_idx), _ = jax.lax.scan(scan_body, init, (centers_b, radii_b, bases))
    hit = best_t < T_FAR
    return best_t, best_idx, hit


def sky_color(direction):
    """Background gradient (the reference's K4, miss_kernel.wgsl:32-33).

    ``direction`` must be unit length (we normalize all rays; the
    reference fed unnormalized bounce directions here — SURVEY.md §8
    bug 3).
    """
    a = 0.5 * (direction[..., 1] + 1.0)
    white = jnp.ones(3, jnp.float32)
    blue = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - a)[..., None] * white + a[..., None] * blue
