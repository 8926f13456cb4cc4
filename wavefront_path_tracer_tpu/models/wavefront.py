"""Wavefront integrator: the reference's five-kernel architecture in XLA.

Reference architecture (``gpu_wavefront_pt/src/path_tracer.rs:279-371``):
generate_rays -> [extend -> host counter readback -> shade + miss ->
host counter readback -> buffer move] x bounces -> accumulate, with
GPU atomics allocating queue slots.

Re-design:

* The whole bounce loop is one on-device ``lax.while_loop`` keyed on the
  live-ray count — the reference's two *blocking host readbacks per
  bounce* (path_tracer.rs:327-345) become zero host syncs.
* Atomic queue appends become deterministic stable-sort compaction
  (ops/compact.py); the extension-ray buffer move (SURVEY.md §8 quirk 6)
  becomes an in-place permutation — no copy at all.
* SoA fixed-capacity queues (origin, direction, throughput, pixel id)
  keep shapes static under jit; dead lanes are masked.
* The extend (intersection) stage optionally runs on ``ray_chunk``-sized
  blocks so compute shrinks with the live count: only
  ``ceil(count / chunk)`` blocks are intersected per bounce, the
  on-device analog of sizing the dispatch from the counter readback
  (path_tracer.rs:282-289).

Termination is exact (live count == 0 or bounce cap) by default; the
reference's lossy ``misses < 128`` drain (SURVEY.md §8 bug 2) is exposed
as ``config.drain_threshold`` for A/B comparison.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops import rng
from wavefront_path_tracer_tpu.ops.bsdf import scatter, scatter_partitioned
from wavefront_path_tracer_tpu.ops.compact import compaction_order
from wavefront_path_tracer_tpu.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu.ops.intersect import T_FAR, sky_color
from wavefront_path_tracer_tpu.ops.raygen import generate_rays
from wavefront_path_tracer_tpu.utils.config import RenderConfig


def _extend(q_origin, q_dir, count, scene_arrays, config: RenderConfig):
    """The extend stage (reference K2): nearest hit + shading inputs for
    the live prefix.

    With ``config.ray_chunk`` set, only ceil(count/chunk) chunks are
    intersected — dead-tail lanes cost nothing.  Returns
    (t, hit, normal, albedo, fuzz, refract, mat).
    """
    capacity = q_origin.shape[0]
    chunk = config.ray_chunk
    if chunk <= 0 or chunk >= capacity:
        return intersect_and_resolve(q_origin, q_dir, scene_arrays, config)

    assert capacity % chunk == 0, "queue capacity must be a ray_chunk multiple"
    bufs = (
        jnp.full((capacity,), T_FAR),            # t
        jnp.zeros((capacity,), bool),            # hit
        jnp.zeros((capacity, 3), jnp.float32),   # normal
        jnp.zeros((capacity, 3), jnp.float32),   # albedo
        jnp.zeros((capacity,), jnp.float32),     # fuzz
        jnp.ones((capacity,), jnp.float32),      # refract
        jnp.zeros((capacity,), jnp.int32),       # mat
    )
    n_chunks = (count + chunk - 1) // chunk

    def cond(state):
        return state[0] < n_chunks

    def body(state):
        k, bufs = state
        start = k * chunk
        o = jax.lax.dynamic_slice_in_dim(q_origin, start, chunk)
        d = jax.lax.dynamic_slice_in_dim(q_dir, start, chunk)
        outs = intersect_and_resolve(o, d, scene_arrays, config)
        bufs = tuple(
            jax.lax.dynamic_update_slice_in_dim(buf, out, start, 0)
            for buf, out in zip(bufs, outs)
        )
        return k + 1, bufs

    _, bufs = jax.lax.while_loop(cond, body, (jnp.int32(0), bufs))
    return bufs


def trace_wavefront(pixel_idx, scene_arrays, cam, view, inv_proj,
                    config: RenderConfig, frame, sample):
    """One sample for a pixel batch via the wavefront loop.

    Returns (radiance (N, 3), rays_traced scalar) where rays_traced is
    the number of live rays processed by extend+shade across all
    bounces — the Mrays/s numerator (BASELINE.json metric).
    """
    n = pixel_idx.shape[0]
    chunk = config.ray_chunk
    capacity = n if chunk <= 0 else ((n + chunk - 1) // chunk) * chunk

    # K1 generate: one primary ray per pixel fills the queue.
    origin, direction = generate_rays(
        pixel_idx, config.width, config.height, frame, sample, cam, view,
        inv_proj, sampler=config.sampler,
    )
    pad = capacity - n
    # Two ids per lane: the *global* pixel id drives RNG streams (must
    # match the megakernel oracle under sharding, where pixel_idx is a
    # tile of the full index space); the *local* slot addresses this
    # batch's radiance buffer.
    q_pixel = jnp.concatenate([pixel_idx.astype(jnp.uint32), jnp.zeros((pad,), jnp.uint32)])
    q_slot = jnp.concatenate([jnp.arange(n, dtype=jnp.int32), jnp.zeros((pad,), jnp.int32)])
    q_origin = jnp.concatenate([origin, jnp.zeros((pad, 3), jnp.float32)])
    q_dir = jnp.concatenate([direction, jnp.ones((pad, 3), jnp.float32)])
    q_throughput = jnp.ones((capacity, 3), jnp.float32)
    radiance = jnp.zeros((n, 3), jnp.float32)
    lane = jnp.arange(capacity, dtype=jnp.int32)

    rays_traced = jnp.int32(0)

    def cond(state):
        bounce, count, last_missed = state[0], state[1], state[2]
        if config.drain_threshold:
            # The reference's lossy drain heuristic gates on the MISS
            # count of the previous bounce (`num_misses < 128` breaks,
            # path_tracer.rs:330-332) — not on the live count.  Less
            # lossy than the reference in one respect: our current
            # bounce's misses were already sky-shaded before the break
            # (the reference discards them entirely, SURVEY.md §8 bug 2).
            active = ((count > 0)
                      & ((bounce == 0)
                         | (last_missed >= config.drain_threshold)))
        else:
            active = count > 0  # exact termination (default)
        return (bounce < config.max_bounces) & active

    def body(state):
        (bounce, count, last_missed, q_pixel, q_slot, q_origin, q_dir,
         q_throughput, radiance, rays_traced) = state
        rays_traced = rays_traced + count
        live = lane < count

        # K2 extend (+ hit resolution: normal/material of the winner).
        t, hit, normal, albedo, fuzz, refract, mat = _extend(
            q_origin, q_dir, count, scene_arrays, config)
        hit = hit & live
        missed = live & ~hit

        if config.material_split:
            # Per-material shade on a material-partitioned queue — the
            # reference's TODO (README.md:19) done for real: partition
            # by the material the lane is ABOUT to shade (the extend
            # winner), so the shade stage runs over contiguous
            # same-material segments.  Dead lanes sort last, which also
            # pre-compacts.  Results are bit-identical (RNG is keyed by
            # pixel; the radiance scatter is slot-addressed).  It costs
            # one extra permutation per bounce and is kept opt-in until
            # a GPU measurement shows divergence savings pay for it.
            key = jnp.where(hit, mat, jnp.int32(3))
            idx32 = jnp.arange(key.shape[0], dtype=jnp.int32)
            _, order0 = jax.lax.sort_key_val(key, idx32, is_stable=True)
            (q_pixel, q_slot, q_origin, q_dir, q_throughput) = (
                q_pixel[order0], q_slot[order0], q_origin[order0],
                q_dir[order0], q_throughput[order0])
            (t, hit, normal, albedo, fuzz, refract, mat, missed) = (
                t[order0], hit[order0], normal[order0], albedo[order0],
                fuzz[order0], refract[order0], mat[order0],
                missed[order0])

        # K4 miss: terminal sky contribution, scattered back to pixels.
        sky = q_throughput * sky_color(q_dir)
        if config.clamp > 0.0:
            sky = jnp.minimum(sky, config.clamp)  # per-sample firefly clamp
        radiance = radiance.at[q_slot].add(
            jnp.where(missed[:, None], sky, 0.0), mode="drop"
        )

        # K3 shade: attenuate + scatter, RNG stream keyed by *pixel*
        # (deterministic; unlike reference shade.wgsl:72's queue-slot
        # seed).  scatter == scatter_partitioned by construction
        # (ops/bsdf.py), so material_split's partition above is the
        # whole difference between the two architectures.
        p = q_origin + t[:, None] * q_dir
        state_rng = rng.stream_state(q_pixel, frame, sample, bounce + 1)
        # Scatter draws are never stratified (ops/bsdf.py:_draws — a
        # shared stratum index across bounce dims is a biased joint).
        new_dir = scatter(state_rng, q_dir, normal, mat, fuzz, refract)
        q_throughput = jnp.where(
            hit[:, None], q_throughput * albedo, q_throughput
        )
        q_origin = jnp.where(hit[:, None], p, q_origin)
        q_dir = jnp.where(hit[:, None], new_dir, q_dir)
        if config.rr_start_bounce:
            # Russian roulette via the shared helper
            # (ops/rng.py:roulette) — keyed by pixel, so compaction
            # order is irrelevant and the megakernel stream matches
            # bit-exactly.
            q_throughput, hit = rng.roulette(
                q_pixel, frame, sample, bounce + 1, q_throughput, hit,
                config.rr_start_bounce, config.rr_floor)

        # Compact: survivors to the queue front (replaces atomic appends
        # + the extension-buffer move, path_tracer.rs:348).  Under
        # material_split the queue is already material-partitioned with
        # dead lanes last; the stable compaction preserves that order.
        order, new_count = compaction_order(hit)
        q_pixel = q_pixel[order]
        q_slot = q_slot[order]
        q_origin = q_origin[order]
        q_dir = q_dir[order]
        q_throughput = q_throughput[order]
        n_missed = jnp.sum(missed.astype(jnp.int32))
        return (bounce + 1, new_count, n_missed, q_pixel, q_slot, q_origin,
                q_dir, q_throughput, radiance, rays_traced)

    state = (jnp.int32(0), jnp.int32(n), jnp.int32(0), q_pixel, q_slot,
             q_origin, q_dir, q_throughput, radiance, rays_traced)
    state = jax.lax.while_loop(cond, body, state)
    return state[8], state[9]


@functools.partial(jax.jit, static_argnames=("cam", "config"))
def bounce_histogram(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                     frame, sample):
    """Queue-occupancy diagnostics: live-ray count entering each bounce.

    The observability the reference only printed as per-sample counter
    readbacks (path_tracer.rs:327-345): returns a (max_bounces,) int32
    array of queue occupancies for one sample, for compaction-efficiency
    analysis and SPF tuning.
    """
    num_pixels = config.num_pixels
    pixel_idx = jnp.arange(num_pixels, dtype=jnp.uint32)
    origin, direction = generate_rays(
        pixel_idx, config.width, config.height, frame, sample,
        cam, view, inv_proj, sampler=config.sampler,
    )
    hist = jnp.zeros((config.max_bounces,), jnp.int32)
    throughput = jnp.ones((num_pixels, 3), jnp.float32)

    def body(bounce, state):
        origin, direction, alive, hist = state
        hist = hist.at[bounce].set(jnp.sum(alive.astype(jnp.int32)))
        t, hit, normal, albedo, fuzz, refract, mat = intersect_and_resolve(
            origin, direction, scene_arrays, config)
        p = origin + t[:, None] * direction
        state_rng = rng.stream_state(pixel_idx, frame, sample, bounce + 1)
        new_dir = scatter(state_rng, direction, normal, mat, fuzz, refract)
        hit_alive = alive & hit
        origin = jnp.where(hit_alive[:, None], p, origin)
        direction = jnp.where(hit_alive[:, None], new_dir, direction)
        return origin, direction, hit_alive, hist

    state = (origin, direction, jnp.ones((num_pixels,), bool), hist)
    _, _, _, hist = jax.lax.fori_loop(0, config.max_bounces, body, state)
    return hist


@functools.partial(jax.jit, static_argnames=("cam", "config", "n_samples"))
def render_samples(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                   frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples; ((P, 3), rays_traced)."""
    num_pixels = config.num_pixels
    pixel_idx = jnp.arange(num_pixels, dtype=jnp.uint32)

    def one_sample(s, carry):
        acc, rays = carry
        rad, r = trace_wavefront(
            pixel_idx, scene_arrays, cam, view, inv_proj, config, frame,
            sample_base + jnp.uint32(s),
        )
        # f32 count: avoids int32 overflow at billions of rays; the
        # ~2^-24 relative rounding is irrelevant for a throughput metric.
        return acc + rad, rays + r.astype(jnp.float32)

    acc = jnp.zeros((num_pixels, 3), jnp.float32)
    acc, rays = jax.lax.fori_loop(0, n_samples, one_sample, (acc, jnp.float32(0)))
    return acc, rays


# --- host-stepped diagnostic path with per-kernel timing -------------
#
# The production wavefront loop above runs entirely on device (zero host
# syncs).  This variant deliberately reproduces the reference's
# orchestration shape — one dispatch per kernel with blocking counter
# readbacks between bounces (path_tracer.rs:279-371) — so each of the
# K1-K4 stages can be wall-clock timed like the reference's per-kernel
# GPU timestamps (path_tracer.rs:356-365, query_gpu.rs).  ~2 host
# round-trips per bounce: diagnostic use only.

@functools.partial(jax.jit,
                   static_argnames=("width", "height", "cam", "sampler"))
def _k1_generate(pixel_idx, width, height, frame, sample, cam, view,
                 inv_proj, sampler="random"):
    return generate_rays(pixel_idx, width, height, frame, sample, cam,
                         view, inv_proj, sampler=sampler)


@functools.partial(jax.jit, static_argnames=("config",))
def _k2_extend(q_origin, q_dir, count, scene_arrays, config):
    return _extend(q_origin, q_dir, count, scene_arrays, config)


@functools.partial(jax.jit, static_argnames=("clamp",))
def _k4_miss(radiance, q_slot, q_throughput, q_dir, missed, clamp=0.0):
    sky = q_throughput * sky_color(q_dir)
    if clamp > 0.0:
        sky = jnp.minimum(sky, clamp)  # per-sample firefly clamp
    return radiance.at[q_slot].add(
        jnp.where(missed[:, None], sky, 0.0), mode="drop")


@jax.jit
def _k3_shade(q_pixel, frame, sample, bounce, q_origin, q_dir,
              q_throughput, t, hit, normal, albedo, fuzz, refract, mat):
    p = q_origin + t[:, None] * q_dir
    state_rng = rng.stream_state(q_pixel, frame, sample, bounce + 1)
    new_dir = scatter(state_rng, q_dir, normal, mat, fuzz, refract)
    q_throughput = jnp.where(hit[:, None], q_throughput * albedo,
                             q_throughput)
    q_origin = jnp.where(hit[:, None], p, q_origin)
    q_dir = jnp.where(hit[:, None], new_dir, q_dir)
    return q_origin, q_dir, q_throughput


@jax.jit
def _compact(hit, q_pixel, q_slot, q_origin, q_dir, q_throughput):
    order, new_count = compaction_order(hit)
    return (q_pixel[order], q_slot[order], q_origin[order], q_dir[order],
            q_throughput[order], new_count)


def render_samples_staged(scene_arrays, cam, view, inv_proj,
                          config: RenderConfig, frame, sample_base,
                          n_samples: int, timer):
    """render_samples-compatible host-stepped loop; per-stage wall times
    accumulate into ``timer`` (a utils.profiling.KernelTimer) under the
    reference's kernel names: generate / extend / shade / miss (+
    compact, which the reference folds into its atomics)."""
    n = config.num_pixels
    pixel_idx = jnp.arange(n, dtype=jnp.uint32)
    radiance = jnp.zeros((n, 3), jnp.float32)
    rays_total = 0
    frame = jnp.uint32(frame)

    for s in range(n_samples):
        sample = jnp.uint32(sample_base) + jnp.uint32(s)
        with timer.time("generate"):
            origin, direction = _k1_generate(
                pixel_idx, config.width, config.height, frame, sample,
                cam, view, inv_proj, sampler=config.sampler)
            jax.block_until_ready(direction)
        q_pixel = pixel_idx
        q_slot = jnp.arange(n, dtype=jnp.int32)
        q_origin, q_dir = origin, direction
        q_throughput = jnp.ones((n, 3), jnp.float32)
        count = n
        bounce = 0
        while count > 0 and bounce < config.max_bounces:
            lane = jnp.arange(q_origin.shape[0], dtype=jnp.int32)
            live = lane < count
            rays_total += count
            with timer.time("extend"):
                t, hit, normal, albedo, fuzz, refract, mat = _k2_extend(
                    q_origin, q_dir, jnp.int32(count), scene_arrays, config)
                jax.block_until_ready(t)
            hit = hit & live
            with timer.time("miss"):
                radiance = _k4_miss(radiance, q_slot, q_throughput, q_dir,
                                    live & ~hit, clamp=config.clamp)
                jax.block_until_ready(radiance)
            with timer.time("shade"):
                q_origin, q_dir, q_throughput = _k3_shade(
                    q_pixel, frame, sample, jnp.uint32(bounce), q_origin,
                    q_dir, q_throughput, t, hit, normal, albedo, fuzz,
                    refract, mat)
                jax.block_until_ready(q_dir)
            with timer.time("compact"):
                (q_pixel, q_slot, q_origin, q_dir, q_throughput,
                 new_count) = _compact(hit, q_pixel, q_slot, q_origin,
                                       q_dir, q_throughput)
                # The blocking counter readback the reference does twice
                # per bounce (path_tracer.rs:327-345) — here it is also
                # what sizes the next host iteration.
                count = int(new_count)
            bounce += 1
    return radiance, jnp.float32(rays_total)
