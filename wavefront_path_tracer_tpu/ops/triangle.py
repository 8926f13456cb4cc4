"""Ray-triangle intersection (Moller-Trumbore), vectorized over wavefronts.

No reference analog — the reference renders spheres only; triangle
meshes are its own future-work list ("load object files",
README.md:22-26) and BASELINE.json config 5.  Same structure as
ops/intersect.py: dense (rays x triangle-block) vector math via
lax.scan, no per-lane gathers.

Triangles are stored SoA as (v0, e1, e2) with e1 = v1 - v0,
e2 = v2 - v0 precomputed on the host; geometric normals are
normalize(cross(e1, e2)) under counter-clockwise winding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops.intersect import T_FAR, T_MIN

_EPS_DET = 1e-9


def _tri_hit_t(origin, direction, v0, e1, e2):
    """Hit parameter per (ray, triangle) pair, or T_FAR.

    origin/direction: (N, 3); v0/e1/e2: (B, 3).  Returns (N, B).
    Two-sided test (glass plates need back faces).
    """
    d = direction[:, None, :]                      # (N, 1, 3)
    pvec = jnp.cross(d, e2[None, :, :])            # (N, B, 3)
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # (N, B)
    inv_det = jnp.where(jnp.abs(det) > _EPS_DET, 1.0 / det, 0.0)
    tvec = origin[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > _EPS_DET)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > T_MIN)
    )
    return jnp.where(valid, t, T_FAR)


def triangle_t(origin, direction, v0, e1, e2):
    """Per-lane hit parameter for ONE triangle per ray, or T_FAR.

    origin/direction: (N, 3); v0/e1/e2: (N, 3) — gathered per lane (the
    BVH leaf-test shape).  Two-sided.
    """
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > _EPS_DET, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > _EPS_DET)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > T_MIN)
    )
    return jnp.where(valid, t, T_FAR)


@functools.partial(jax.jit, static_argnames=("tri_chunk",))
def intersect_triangles(origin, direction, v0, e1, e2, tri_chunk: int = 128):
    """Nearest triangle hit; returns (t (N,), tri_idx (N,) i32, hit (N,))."""
    n_tris = v0.shape[0]
    pad = (-n_tris) % tri_chunk
    if pad:
        # Degenerate (zero-area) padding triangles never pass the det test.
        z = jnp.zeros((pad, 3), v0.dtype)
        v0 = jnp.concatenate([v0, z])
        e1 = jnp.concatenate([e1, z])
        e2 = jnp.concatenate([e2, z])
    n_blocks = v0.shape[0] // tri_chunk
    v0b = v0.reshape(n_blocks, tri_chunk, 3)
    e1b = e1.reshape(n_blocks, tri_chunk, 3)
    e2b = e2.reshape(n_blocks, tri_chunk, 3)

    def scan_body(carry, block):
        best_t, best_idx = carry
        bv0, be1, be2, base = block
        t = _tri_hit_t(origin, direction, bv0, be1, be2)
        arg = jnp.argmin(t, axis=-1)
        tmin = jnp.take_along_axis(t, arg[:, None], axis=-1)[:, 0]
        better = tmin < best_t
        best_idx = jnp.where(better, base + arg.astype(jnp.int32), best_idx)
        best_t = jnp.where(better, tmin, best_t)
        return (best_t, best_idx), None

    n_rays = origin.shape[0]
    init = (jnp.full((n_rays,), T_FAR), jnp.zeros((n_rays,), jnp.int32))
    bases = jnp.arange(n_blocks, dtype=jnp.int32) * tri_chunk
    (best_t, best_idx), _ = jax.lax.scan(scan_body, init, (v0b, e1b, e2b, bases))
    return best_t, best_idx, best_t < T_FAR


def triangle_normals(e1, e2):
    """Unit geometric normals (CCW winding)."""
    n = jnp.cross(e1, e2)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)
