"""Persistent XLA compilation cache.

Compiling a render step for the GPU takes seconds to minutes per
configuration; a persistent cache lets every later process that renders
the same configuration skip it.  ``activate()`` attaches the cache once
the platform choice is final (``prepare_scene`` and ``Renderer`` call
it).

Where the cache lives (``cache_dir``):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself and
  this module sets no directory.
* otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  One
  fixed path, because the path is part of what makes the cache hit:
  processes started from the same checkout share their compiles.

The cache is never attached on the CPU backend.  XLA:CPU persistent
entries are AOT machine code whose embedded target tuning must match
the loading process exactly; deserializing a mismatched entry can crash
inside the cache read (SIGILL / SIGSEGV), and XLA logs "Machine type
used for XLA:CPU compilation doesn't match the machine type for
execution" for such entries.  CPU compiles take seconds, so the cache
buys little there and carries a native-crash class.
"""

from __future__ import annotations

import os
from typing import Mapping

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_activated = False


def cache_dir(environ: Mapping[str, str] = os.environ) -> str | None:
    """The directory this module points JAX at, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses that value)."""
    if environ.get(ENV_VAR):
        return None
    return DEFAULT_DIR


def activate() -> None:
    """Attach the persistent cache iff the default backend is not the
    CPU.  Idempotent; call after the platform is decided."""
    global _activated
    if _activated:
        return
    import jax

    _activated = True            # decide once per process
    if jax.default_backend() == "cpu":
        return                   # see module docstring: CPU is unsafe
    path = cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
