"""Megakernel oracle integrator.

The straight-line per-pixel path tracer the reference never finished
(its ``cpu_wavefront_pt`` crate is an empty stub): every pixel carries
its own ray through a masked bounce loop with no queues and no
compaction.  This is the *golden oracle* — simple enough to trust,
jittable on CPU and GPU — that the wavefront engine is validated
against (SURVEY.md §4).

Structure per bounce (mirrors the reference kernel split semantics):
ray gen (K1) -> intersect (K2) -> shade hits (K3) / sky misses (K4),
with radiance = throughput * sky on miss and 0 for rays still alive at
the bounce cap (exact termination; the reference's lossy early-drain
break is SURVEY.md §8 bug 2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops import rng
from wavefront_path_tracer_tpu.ops.bsdf import scatter
from wavefront_path_tracer_tpu.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu.ops.intersect import sky_color
from wavefront_path_tracer_tpu.ops.raygen import generate_rays
from wavefront_path_tracer_tpu.utils.config import RenderConfig


def trace_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                 config: RenderConfig, frame, sample):
    """Trace one sample for a batch of pixels.

    Returns (radiance (N, 3), rays_traced scalar) — the live-lane count
    summed over bounces, for Mrays/s accounting."""
    origin, direction = generate_rays(
        pixel_idx, config.width, config.height, frame, sample, cam, view,
        inv_proj, sampler=config.sampler,
    )
    n = pixel_idx.shape[0]
    throughput = jnp.ones((n, 3), jnp.float32)
    radiance = jnp.zeros((n, 3), jnp.float32)
    # Chunk-padding lanes (pixel_idx beyond the image) start dead: they
    # cost no trace work and are excluded from the Mrays/s numerator.
    alive = pixel_idx < jnp.uint32(config.num_pixels)

    def cond(state):
        bounce, _, _, _, _, alive, _ = state
        return (bounce < config.max_bounces) & jnp.any(alive)

    def body(state):
        bounce, origin, direction, throughput, radiance, alive, rays = state
        rays = rays + jnp.sum(alive.astype(jnp.int32))
        t, hit, normal, albedo, fuzz, refract, mat = intersect_and_resolve(
            origin, direction, scene_arrays, config)

        # Miss: terminal sky contribution (K4 semantics).
        missed = alive & ~hit
        contrib = throughput * sky_color(direction)
        if config.clamp > 0.0:
            # Per-sample firefly clamp (the miss event carries the
            # sample's whole radiance).
            contrib = jnp.minimum(contrib, config.clamp)
        radiance = radiance + jnp.where(missed[:, None], contrib, 0.0)

        # Hit: attenuate and scatter (K3 semantics).
        p = origin + t[:, None] * direction
        state_rng = rng.stream_state(pixel_idx, frame, sample, bounce + 1)
        new_dir = scatter(state_rng, direction, normal, mat, fuzz, refract)
        hit_alive = alive & hit
        throughput = jnp.where(
            hit_alive[:, None], throughput * albedo, throughput,
        )
        origin = jnp.where(hit_alive[:, None], p, origin)
        direction = jnp.where(hit_alive[:, None], new_dir, direction)
        if config.rr_start_bounce:
            # Russian roulette (unbiased): shared helper so the stream
            # and semantics match the wavefront engine bit-exactly
            # (ops/rng.py:roulette).
            throughput, hit_alive = rng.roulette(
                pixel_idx, frame, sample, bounce + 1, throughput,
                hit_alive, config.rr_start_bounce, config.rr_floor)
        return bounce + 1, origin, direction, throughput, radiance, hit_alive, rays

    state = (jnp.int32(0), origin, direction, throughput, radiance, alive, jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    return state[4], state[6]


@functools.partial(jax.jit, static_argnames=("cam", "config", "n_samples"))
def render_samples(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                   frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples; ((P, 3), rays_traced)."""
    num_pixels = config.num_pixels
    chunk = config.ray_chunk or min(num_pixels, 131072)
    pad = (-num_pixels) % chunk
    pixel_idx = jnp.arange(num_pixels + pad, dtype=jnp.uint32)
    chunks = pixel_idx.reshape(-1, chunk)

    def one_sample(s, carry):
        acc, rays = carry
        sample = sample_base + jnp.uint32(s)

        def per_chunk(idx_chunk):
            return trace_pixels(
                idx_chunk, scene_arrays, cam, view, inv_proj, config, frame, sample
            )

        rad, r = jax.lax.map(per_chunk, chunks)
        rad = rad.reshape(-1, 3)
        return acc + rad[:num_pixels], rays + jnp.sum(r).astype(jnp.float32)

    acc = jnp.zeros((num_pixels, 3), jnp.float32)
    acc, rays = jax.lax.fori_loop(0, n_samples, one_sample, (acc, jnp.float32(0)))
    return acc, rays
