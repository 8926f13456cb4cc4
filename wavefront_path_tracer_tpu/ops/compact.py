"""Deterministic stream compaction.

The reference compacts ray queues with GPU atomic-counter appends
(``extend.wgsl:66-69``, ``shade.wgsl:155``), which makes queue order —
and therefore its shade RNG — nondeterministic (SURVEY.md §8 quirk 5).
We compact with a stable sort-by-liveness permutation instead, for
determinism: survivors keep their relative order at the front of the
queue, so two renders of one config are bit-identical.

``jax.lax.sort_key_val`` with one extra operand (the lane index) gives
the permutation, applied to every SoA queue column with plain gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compaction_order(keep: jnp.ndarray):
    """Returns (order, count): a permutation putting kept lanes first
    (stable) and the number of kept lanes."""
    n = keep.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # Stable ascending sort of (not keep): kept lanes (key 0) come first.
    _, order = jax.lax.sort_key_val((~keep).astype(jnp.int32), idx, is_stable=True)
    return order, jnp.sum(keep.astype(jnp.int32))


def compact(keep: jnp.ndarray, *arrays):
    """Compact every array (along axis 0) by the same liveness mask.

    Returns (count, *compacted_arrays).  Lanes >= count hold the dropped
    entries (in stable order) — callers must treat them as garbage.
    """
    order, count = compaction_order(keep)
    return (count, *[a[order] for a in arrays])
