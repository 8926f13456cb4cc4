"""Render configuration.

The reference hardcodes its knobs (2880x1620 viewport in
``gpu_wavefront_pt/src/main.rs:33``, ``SPP=10`` / ``SPF=1`` compile-time
constants in ``wavefront_common/src/parameters.rs:4-5``, bounce cap 50
and the queue-drain heuristic 128 as literals in
``gpu_wavefront_pt/src/path_tracer.rs:323,332``, ``USE_BVH`` baked into
shader source at ``extend.wgsl:1``).  Here they are one dataclass that
doubles as the CLI surface.
"""

from __future__ import annotations

import dataclasses

ENGINES = ("wavefront", "megakernel")
INTERSECTORS = ("bvh", "bruteforce")
# The production engine and intersector: the fastest combination at the
# 1080p book_one_final headline on an H100, where the lockstep BVH loop
# measured ~8x slower than brute force (PERF.md).  The CLI, bench.py,
# validate.py and the driver entry points all default to these.
DEFAULT_ENGINE = "wavefront"
DEFAULT_INTERSECTOR = "bruteforce"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of a render.

    Frozen + hashable so it can be a jit static argument.
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 10        # reference SPP (parameters.rs:4)
    samples_per_frame: int = 1         # reference SPF (parameters.rs:5)
    max_bounces: int = 50              # reference bounce cap (path_tracer.rs:323)
    frame: int = 0                     # RNG frame salt
    engine: str = DEFAULT_ENGINE         # one of ENGINES
    intersector: str = DEFAULT_INTERSECTOR  # one of INTERSECTORS
    ray_chunk: int = 0                 # 0 = whole wavefront in one chunk
    sphere_chunk: int = 128            # spheres per intersection block
    # Wavefront engine: partition the hit queue by material and shade
    # with per-material kernels (the reference's TODO, README.md:19).
    material_split: bool = False
    # Multi-chip: number of devices to shard pixels over (1 = single chip).
    num_devices: int = 1
    # Russian roulette: 0 disables (default — matches the reference's
    # always-trace-to-cap semantics); N > 0 starts unbiased roulette at
    # the N-th surface event (continue with p = max throughput
    # component, survivors compensated by 1/p).  The roulette draw uses
    # an independently salted RNG stream, so rr-off renders are
    # bit-identical with or without this feature.  Supported by all
    # engines; cuts time-to-N-spp on bounce-heavy scenes.
    rr_start_bounce: int = 0
    # Russian roulette survival floor: the continue probability is
    # clip(max(throughput), rr_floor, 1).  A higher floor kills fewer
    # dark paths (less variance in the killed tail — fewer fireflies)
    # at the cost of tracing more of them; tune together with
    # rr_start_bounce for the speed/variance frontier.
    rr_floor: float = 0.05
    # AA sampler: "random" (the reference's pure-PCG disk jitter) or
    # "stratified" (the two AA-disk uniforms remapped onto a 4x4
    # stratum grid cycling with the sample index — same draw count and
    # stream positions, so lens and bounce streams are untouched;
    # unbiased, lower pixel variance at low spp).  All engines share
    # the formula, so cross-engine bit-identity is preserved.
    sampler: str = "random"
    # Per-sample componentwise radiance clamp (standard production
    # control).  0 disables.  NOTE: this renderer's per-sample radiance
    # is <= 1 by construction (multiplicative albedo <= 1, sky <= 1,
    # roulette weight division bounded by max-throughput survival), so
    # values >= 1 are provably inert (exp/clamp_bias.py measures 0
    # bias); < 1 darkens highlights in exchange for variance.
    clamp: float = 0.0
    # Adaptive stop: end the progressive loop when the mean absolute
    # display-image change per frame batch falls below this (the SPP
    # budget stays the hard cap).  0 disables.
    stop_delta: float = 0.0
    # Exact termination (0, default) vs the reference's lossy early
    # break (path_tracer.rs:330-332): with N > 0 the wavefront loop
    # stops once a bounce produces fewer than N misses — the reference's
    # exact quantity (its literal is 128).
    drain_threshold: int = 0

    def __post_init__(self) -> None:
        # A negative start bounce has no meaning: the engines compare it
        # against a bounce index, so it would read as "always active".
        if self.rr_start_bounce < 0:
            raise ValueError(
                f"rr_start_bounce must be >= 0, got {self.rr_start_bounce} "
                "(0 disables Russian roulette)")
        if self.drain_threshold < 0:
            raise ValueError(
                f"drain_threshold must be >= 0, got {self.drain_threshold}")
        if not 0.0 < self.rr_floor <= 1.0:
            raise ValueError(
                f"rr_floor must be in (0, 1], got {self.rr_floor} "
                "(a zero floor would divide by a zero continue probability)")
        if self.clamp < 0.0:
            raise ValueError("clamp must be >= 0 (0 disables)")
        if self.stop_delta < 0.0:
            raise ValueError("stop_delta must be >= 0 (0 disables)")
        if self.sampler not in ("random", "stratified"):
            raise ValueError(
                f"sampler must be 'random' or 'stratified', "
                f"got {self.sampler!r}")
        if self.engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.intersector not in INTERSECTORS:
            raise ValueError(
                f"intersector must be one of {INTERSECTORS}, "
                f"got {self.intersector!r}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RenderProgress:
    """Progressive accumulation bookkeeping (reference parameters.rs:61-101)."""

    frame: int = 0
    accumulated_samples: int = 0

    def progress(self, spp: int) -> float:
        return min(1.0, self.accumulated_samples / max(1, spp))

    def reset(self) -> None:
        self.frame = 0
        self.accumulated_samples = 0
