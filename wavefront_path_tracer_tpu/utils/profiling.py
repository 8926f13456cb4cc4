"""Instrumentation: per-stage timing, FPS, and throughput accounting.

Re-expresses the reference's observability stack in JAX:

* ``KernelTimer`` — the analog of the GPU timestamp-query machinery
  (``gpu_wavefront_pt/src/query_gpu.rs``): named stages with a 10-deep
  running average (query_gpu.rs:17).  Stages are jit calls timed with
  ``block_until_ready`` wall clock; for per-kernel device times use
  ``jax.profiler.trace`` (see ``trace_to``).
* ``FramesPerSecond`` — 10-frame moving average
  (``wavefront_common/src/frames_per_second.rs``).
* ``RenderStats`` — per-frame ray/bounce accounting and Mrays/s, the
  queue-occupancy observability the reference only printed to stdout
  (path_tracer.rs:364).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict

import jax

RUNNING_AVG_LENGTH = 10  # matches query_gpu.rs:17


class _RunningAverage:
    def __init__(self, length: int = RUNNING_AVG_LENGTH):
        self._window = collections.deque(maxlen=length)

    def update(self, value: float) -> None:
        self._window.append(value)

    @property
    def average(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0


class KernelTimer:
    """Wall-clock stage timer with running averages per stage name."""

    def __init__(self) -> None:
        self._stages: Dict[str, _RunningAverage] = {}

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self._stages.setdefault(name, _RunningAverage()).update(dt)

    def record(self, name: str, seconds: float) -> None:
        self._stages.setdefault(name, _RunningAverage()).update(seconds)

    def averages_us(self) -> Dict[str, float]:
        """Per-stage averaged microseconds (the reference prints µs)."""
        return {k: v.average * 1e6 for k, v in self._stages.items()}

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.0f}us" for k, v in self.averages_us().items())


class FramesPerSecond:
    """10-frame moving-average FPS (frames_per_second.rs:9-27)."""

    def __init__(self) -> None:
        self._avg = _RunningAverage()
        self._last = None

    def update(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._avg.update(now - self._last)
        self._last = now

    def get_avg_fps(self) -> float:
        dt = self._avg.average
        return 1.0 / dt if dt > 0 else 0.0


@dataclasses.dataclass
class RenderStats:
    """Per-frame accounting for throughput reports."""

    rays_traced: float = 0.0
    seconds: float = 0.0
    samples: int = 0
    pixels: int = 0

    @property
    def mrays_per_s(self) -> float:
        return self.rays_traced / self.seconds / 1e6 if self.seconds > 0 else 0.0

    @property
    def avg_bounces(self) -> float:
        paths = self.samples * self.pixels
        return self.rays_traced / paths if paths else 0.0

    def report(self) -> str:
        return (
            f"{self.rays_traced/1e6:.1f} Mrays in {self.seconds:.3f}s "
            f"= {self.mrays_per_s:.1f} Mrays/s "
            f"(avg {self.avg_bounces:.2f} bounces/path)"
        )


@contextlib.contextmanager
def trace_to(log_dir: str):
    """XLA-level profiling via jax.profiler (the deep-dive tool the
    reference's timestamp queries approximate)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
