"""Material scattering (the reference's K3, shade.wgsl:84-176).

One branchless vectorized scatter over the whole wavefront: all three
BSDFs are evaluated masked and selected with ``jnp.where`` (no
gathers/scatters, no queue management); a per-material partitioned path
is available in the wavefront engine for A/B.

RNG contract: every shading event consumes draws from its own
``(pixel, frame, sample, bounce)`` stream in a fixed order —
3 draws for the unit-sphere sample, then 1 draw for the dielectric
reflectance test — so engines agree bit-for-bit no matter which
materials their queues contain.

Material semantics (mirroring shade.wgsl:101-152):
* 0 Lambertian: ``d' = n + unit_sphere_sample`` with degenerate fallback
  to ``n`` when ``|d'| < 0.001``.
* 1 Metal: ``d' = reflect(d, n) + fuzz * unit_sphere_sample``.  Like the
  reference, no absorb-on-subsurface-scatter check.
* 2 Dielectric: outward normal convention with inside-flip, Schlick
  reflectance vs. an RNG draw, refract with total-internal-reflection
  fallback.  Albedo is white (material.rs:35).

Deviation (deliberate): returned directions are normalized
(SURVEY.md §8 bug 3 — the reference's are not).
"""

from __future__ import annotations

import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops import rng


def reflect(d, n):
    """Mirror reflection (shade.wgsl:164-166)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def schlick(cosine, eta):
    """Schlick reflectance approximation (shade.wgsl:158-162)."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, jnp.float32(5.0))


def _draws(state):
    """The fixed per-event draw sequence shared by every shade path:
    3 unit-sphere draws then 1 reflectance draw (module docstring).

    Scatter draws are NEVER stratified: stratification is only unbiased
    when the stratum cells tile the integration domain, and a shared
    per-sample stratum index across bounce dimensions puts the joint
    measure on a fixed diagonal of cells (uniform marginals, biased
    joint — measured as a persistent 6e-3 RMSE floor vs the 1000-spp
    golden oracle that no spp count removes).  Only the 2-D AA jitter
    is stratified (ops/raygen.py), which IS a proper 16-cell tiling."""
    state, u1 = rng.next_f32(state)
    state, u2 = rng.next_f32(state)
    state, u3 = rng.next_f32(state)
    r = jnp.power(u1, jnp.float32(0.33333))
    cos_theta = jnp.float32(1.0) - jnp.float32(2.0) * u2
    sin_theta = jnp.sqrt(jnp.maximum(jnp.float32(0.0),
                                     1.0 - cos_theta * cos_theta))
    phi = jnp.float32(2.0) * jnp.float32(3.1415927) * u3
    sx = r * sin_theta * jnp.cos(phi)
    sy = r * sin_theta * jnp.sin(phi)
    sz = r * cos_theta
    state, r_reflect = rng.next_f32(state)
    s = jnp.stack([sx, sy, sz], axis=-1)
    s = s / jnp.linalg.norm(s, axis=-1, keepdims=True)
    return s, r_reflect


def scatter_lambertian(state, direction, normal, fuzz, refract_idx):
    """Per-material kernel: Lambertian scatter (shade.wgsl:102-109)."""
    s, _ = _draws(state)
    d = normal + s
    degenerate = jnp.linalg.norm(d, axis=-1, keepdims=True) < 0.001
    d = jnp.where(degenerate, normal, d)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def scatter_metal(state, direction, normal, fuzz, refract_idx):
    """Per-material kernel: fuzzy metal (shade.wgsl:110-114)."""
    s, _ = _draws(state)
    d = reflect(direction, normal) + fuzz[:, None] * s
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.where(norm > 1e-12, d / jnp.maximum(norm, 1e-12), normal)


def scatter_dielectric(state, direction, normal, fuzz, refract_idx):
    """Per-material kernel: dielectric (shade.wgsl:115-151)."""
    _, r_reflect = _draws(state)
    uv = direction
    cos_theta = jnp.minimum(jnp.sum(normal * -uv, axis=-1), 1.0)
    outside = cos_theta >= 0.0
    eta = jnp.where(outside, 1.0 / refract_idx, refract_idx)
    n_d = jnp.where(outside[:, None], normal, -normal)
    cos_theta = jnp.where(outside, cos_theta, -cos_theta)
    reflectance = schlick(cos_theta, eta)
    cos_in = jnp.sum(uv * n_d, axis=-1)
    k = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    can_refract = k >= 0.0
    d_refract = (
        eta[:, None] * uv
        - (eta * cos_in + jnp.sqrt(jnp.maximum(k, 0.0)))[:, None] * n_d
    )
    d = jnp.where(
        (can_refract & (reflectance <= r_reflect))[:, None],
        d_refract, reflect(uv, n_d),
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


SCATTER_BY_MATERIAL = (scatter_lambertian, scatter_metal, scatter_dielectric)


def scatter_partitioned(state, direction, normal, mat_type, fuzz,
                        refract_idx):
    """Per-material shading over a material-partitioned queue — the
    reference's own TODO ("per-material shade kernels", README.md:19,
    SURVEY.md §9): the caller sorts the queue by material, then each
    material kernel runs masked over its segment.

    It makes three passes over the queue instead of one; it exists for
    architecture parity and A/B measurement — enable with
    ``RenderConfig(material_split=True)``.  Results match ``scatter``
    exactly (same draws, same per-material math).
    """
    out = jnp.zeros_like(direction)
    for m, fn in enumerate(SCATTER_BY_MATERIAL):
        d_m = fn(state, direction, normal, fuzz, refract_idx)
        out = jnp.where((mat_type == m)[:, None], d_m, out)
    return out


def scatter(
    state: jnp.ndarray,      # (N,) uint32 RNG states (one per shading event)
    direction: jnp.ndarray,  # (N, 3) unit incoming directions
    normal: jnp.ndarray,     # (N, 3) unit outward normals
    mat_type: jnp.ndarray,   # (N,) int32
    fuzz: jnp.ndarray,       # (N,) f32
    refract_idx: jnp.ndarray,  # (N,) f32
):
    """Returns (N, 3) unit scattered directions.

    Defined as the masked composition of the per-material kernels, so
    the branchless path and the partitioned path (material_split) are
    the *same* computation graph — and therefore bit-identical.
    """
    return scatter_partitioned(state, direction, normal, mat_type, fuzz,
                               refract_idx)
