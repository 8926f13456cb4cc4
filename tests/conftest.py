"""Test harness: force CPU with 8 virtual devices so the multi-device
sharding paths are exercised without GPUs.

The platform is pinned *via jax.config* before any backend initializes,
so the tests never claim a GPU even on a machine that has one (a second
JAX process on a card would fail for want of memory).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402,F401
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_cpu_state():
    """Clear JAX/XLA caches between test modules.

    A full suite run accumulates hundreds of XLA:CPU executables (every
    render config is its own LLVM-JITed HLO graph) in one worker
    process; with that state built up, a later compilation has
    segfaulted inside XLA's native ``backend_compile_and_load`` at a
    test that passes in isolation.  Dropping the jit caches at module
    boundaries releases the executables and keeps the per-process
    compiler footprint bounded.
    """
    yield
    import gc

    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="session")
def book_cover_scene():
    from wavefront_path_tracer_tpu.scene import book_cover

    return book_cover()


@pytest.fixture(scope="session")
def final_scene():
    from wavefront_path_tracer_tpu.scene import book_one_final

    return book_one_final(seed=42)


@pytest.fixture(scope="session")
def camera():
    from wavefront_path_tracer_tpu.scene import CameraController

    return CameraController.book_one_final()


def pure_python_pcg_next(state: int):
    """Integer-model PCG-RXS-M-XS (generate_rays.wgsl:146-153)."""
    state = (state * 747796405 + 2891336453) & 0xFFFFFFFF
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & 0xFFFFFFFF
    return state, ((word >> 22) ^ word) & 0xFFFFFFFF


def pure_python_jenkins(x: int) -> int:
    x &= 0xFFFFFFFF
    x = (x + (x << 10)) & 0xFFFFFFFF
    x ^= x >> 6
    x = (x + (x << 3)) & 0xFFFFFFFF
    x ^= x >> 11
    x = (x + (x << 15)) & 0xFFFFFFFF
    return x
