"""Counter-based PCG-RXS-M-XS random number generation, vectorized.

The RNG family mirrors the one used by the reference renderer's WGSL
shaders (PCG-RXS-M-XS output function over a 32-bit LCG state, seeded
through a Jenkins one-at-a-time hash; see
``gpu_wavefront_pt/shaders/generate_rays.wgsl:133-181`` in the reference).
Every function here is bit-exact against a pure-integer model of that
WGSL code and operates elementwise on uint32 arrays of any shape, so a
whole ray wavefront advances its RNG in one VPU op.

Design difference from the reference (deliberate): the reference derives
one sequential stream per *pixel* and advances it by ``sample * 10``
draws, which (a) relies on execution order, (b) overlaps streams when a
sample draws more than 10 values (50 bounces x 3 draws), and (c) in the
shade kernel is seeded from the compacted queue slot rather than the
pixel (reference ``shade.wgsl:57,72``), making images depend on
nondeterministic queue order.  We instead hash an independent stream per
``(pixel, frame, sample, bounce)`` event.  Consequences:

* the megakernel oracle and the wavefront engine consume *identical*
  random values for every path vertex, regardless of queue compaction
  order — renders are bit-reproducible across engines and runs;
* no stream overlap at any bounce depth;
* no sequential ``advance`` needed on the hot path (it is still provided,
  implemented correctly — the reference's ``advance`` applies the
  accumulator only when ``delta == 1`` instead of when the low bit is
  set, i.e. ``advance(n)`` really advances by the highest power of two
  <= n; see reference ``generate_rays.wgsl:155-171``).
"""

from __future__ import annotations

import jax.numpy as jnp

# LCG / PCG constants (reference generate_rays.wgsl:148-152).
PCG_MULT = 747796405
PCG_INC = 2891336453
RXS_M = 277803737

# 1 / 2^32 as float32, matching the WGSL literal (generate_rays.wgsl:135).
_U32_TO_F32 = jnp.float32(2.3283064365387e-10)

_PI = jnp.float32(3.1415927)

# Stream-separation constants for (sample, bounce) decorrelation: odd
# constants from the splitmix64/Weyl family, reduced to 32 bits.
_SAMPLE_STRIDE = 0x9E3779B9  # 2^32 / golden ratio
_BOUNCE_STRIDE = 0x85EBCA6B  # murmur3 finalizer constant


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint32)


def jenkins_hash(x: jnp.ndarray) -> jnp.ndarray:
    """Jenkins one-at-a-time finalizer (reference generate_rays.wgsl:173-181)."""
    x = _u32(x)
    x = x + (x << 10)
    x = x ^ (x >> 6)
    x = x + (x << 3)
    x = x ^ (x >> 11)
    x = x + (x << 15)
    return x


def pcg_output(state: jnp.ndarray) -> jnp.ndarray:
    """RXS-M-XS output permutation of an LCG state (generate_rays.wgsl:146-153)."""
    state = _u32(state)
    word = ((state >> ((state >> 28) + _u32(4))) ^ state) * _u32(RXS_M)
    return (word >> 22) ^ word


def next_u32(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Advance the LCG and return (new_state, random uint32)."""
    new_state = _u32(state) * _u32(PCG_MULT) + _u32(PCG_INC)
    return new_state, pcg_output(new_state)


def next_f32(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Advance and return (new_state, float32 in [0, 1))."""
    state, word = next_u32(state)
    return state, word.astype(jnp.float32) * _U32_TO_F32


def advance(state: jnp.ndarray, delta: int) -> jnp.ndarray:
    """Jump the LCG ahead by ``delta`` draws in O(log delta).

    This is the standard Brown power-of-two PCG advance.  (The reference's
    version has an off-by-condition bug — see module docstring — which we
    do not replicate; nothing on our hot path uses advance.)
    """
    delta = int(delta) & 0xFFFFFFFF
    acc_mult, acc_plus = 1, 0
    cur_mult, cur_plus = PCG_MULT, PCG_INC
    while delta > 0:
        if delta & 1:
            acc_mult = (acc_mult * cur_mult) & 0xFFFFFFFF
            acc_plus = (acc_plus * cur_mult + cur_plus) & 0xFFFFFFFF
        cur_plus = ((cur_mult + 1) * cur_plus) & 0xFFFFFFFF
        cur_mult = (cur_mult * cur_mult) & 0xFFFFFFFF
        delta >>= 1
    return _u32(state) * _u32(acc_mult) + _u32(acc_plus)


def pixel_seed(pixel_idx: jnp.ndarray, frame) -> jnp.ndarray:
    """Per-pixel base seed: jenkins(linear_pixel_idx ^ jenkins(frame)).

    Same construction as the reference's ``init_rng``
    (generate_rays.wgsl:138-141) with the pixel coordinate dot-product
    replaced by the equivalent linear index.
    """
    return jenkins_hash(_u32(pixel_idx) ^ jenkins_hash(_u32(frame)))


def stream_state(pixel_idx: jnp.ndarray, frame, sample, bounce) -> jnp.ndarray:
    """Initial LCG state for the (pixel, frame, sample, bounce) event stream.

    ``bounce`` slot 0 is camera-ray generation; slot ``b + 1`` is the
    shading event after the b-th intersection.  All arguments may be
    traced uint32 arrays or Python ints.
    """
    base = pixel_seed(pixel_idx, frame)
    mixed = base + _u32(sample) * _u32(_SAMPLE_STRIDE) + _u32(bounce) * _u32(_BOUNCE_STRIDE)
    return jenkins_hash(mixed)


_RR_SALT = 0x52455252


def rr_state(pixel_idx: jnp.ndarray, frame, sample, bounce) -> jnp.ndarray:
    """Russian-roulette stream for the same event coordinates.

    Salted independently of :func:`stream_state` so enabling roulette
    never perturbs the scatter/reflectance draws — renders with
    ``rr_start_bounce=0`` stay bit-identical to builds without RR."""
    base = pixel_seed(pixel_idx, frame)
    mixed = (base + _u32(sample) * _u32(_SAMPLE_STRIDE)
             + _u32(bounce) * _u32(_BOUNCE_STRIDE))
    return jenkins_hash(mixed ^ _u32(_RR_SALT))


def roulette(pixel_idx, frame, sample, bounce, throughput, alive,
             start_bounce: int, floor: float = 0.05):
    """Unbiased Russian roulette at one surface event; returns
    ``(throughput, alive)``.

    Shared by the megakernel and wavefront engines so the stream and
    semantics stay identical by construction.  From
    surface event ``start_bounce`` on, paths continue with
    ``p = clip(max(throughput), floor, 1)`` and survivors are
    compensated by ``1/p``; the draw uses :func:`rr_state`, so renders
    where roulette never activates are untouched.
    """
    _, u = next_f32(rr_state(pixel_idx, frame, sample, bounce))
    keep_p = jnp.clip(jnp.max(throughput, axis=-1),
                      jnp.float32(floor), 1.0)
    active = alive & (bounce >= start_bounce)
    survive = (~active) | (u < keep_p)
    throughput = jnp.where((active & survive)[:, None],
                           throughput / keep_p[:, None], throughput)
    return throughput, alive & survive


# --- sampling primitives (formulas mirror generate_rays.wgsl:107-131) ---


def sample_unit_disk(state):
    """Uniform point in the unit disk; returns (state, x, y). 2 draws."""
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    r = jnp.sqrt(u1)
    alpha = jnp.float32(2.0) * _PI * u2
    return state, r * jnp.cos(alpha), r * jnp.sin(alpha)


def sample_unit_sphere(state):
    """Uniform point in the unit ball; returns (state, x, y, z). 3 draws."""
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    state, u3 = next_f32(state)
    r = jnp.power(u1, jnp.float32(0.33333))
    cos_theta = jnp.float32(1.0) - jnp.float32(2.0) * u2
    sin_theta = jnp.sqrt(jnp.maximum(jnp.float32(0.0), 1.0 - cos_theta * cos_theta))
    phi = jnp.float32(2.0) * _PI * u3
    x = r * sin_theta * jnp.cos(phi)
    y = r * sin_theta * jnp.sin(phi)
    z = r * cos_theta
    return state, x, y, z
