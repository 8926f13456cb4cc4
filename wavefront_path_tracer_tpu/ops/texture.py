"""Texture evaluation (BASELINE config-5 stretch; reference future work
``README.md:22-26`` — the reference has no textures at all).

Kinds (per-sphere ``tex_kind``):
  0 solid    — albedo as stored
  1 checker  — RTIOW 3-D checker: sign of sin(s·x)·sin(s·y)·sin(s·z) at
               the *hit point* selects albedo vs albedo2.  Pure
               arithmetic (no memory fetch).
  2 image    — equirect sphere-UV lookup into a stacked RGB texture
               atlas at full resolution: one per-lane gather.
"""

from __future__ import annotations

import jax.numpy as jnp

SOLID = 0
CHECKER = 1
IMAGE = 2


def checker_select(px, py, pz, scale):
    """True where the RTIOW 3-D checker picks the second color."""
    s = jnp.sin(scale * px) * jnp.sin(scale * py) * jnp.sin(scale * pz)
    return s < 0.0


def sphere_uv(normal):
    """RTIOW equirect parametrization from the unit outward normal:
    u = phi / 2pi, v = theta / pi with theta = acos(-y),
    phi = atan2(-z, x) + pi."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    theta = jnp.arccos(jnp.clip(-ny, -1.0, 1.0))
    phi = jnp.arctan2(-nz, nx) + jnp.pi
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def image_lookup(tex_data, tex_id, u, v):
    """Nearest-texel fetch from a (T, H, W, 3) atlas (v flipped so v=0
    is the bottom row, matching RTIOW image orientation)."""
    t, h, w = tex_data.shape[0], tex_data.shape[1], tex_data.shape[2]
    del t
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(((1.0 - v) * h).astype(jnp.int32), 0, h - 1)
    return tex_data[tex_id, y, x]


def resolve_albedo(albedo, tex_kind, tex_albedo2, tex_scale, tex_id,
                   p, normal, tex_data=None):
    """Textured albedo for (N,) lanes; pass-through where tex_kind==0."""
    sel = checker_select(p[..., 0], p[..., 1], p[..., 2], tex_scale)
    albedo = jnp.where(((tex_kind == CHECKER) & sel)[..., None],
                       tex_albedo2, albedo)
    if tex_data is not None:
        u, v = sphere_uv(normal)
        albedo = jnp.where((tex_kind == IMAGE)[..., None],
                           image_lookup(tex_data, tex_id, u, v), albedo)
    return albedo
