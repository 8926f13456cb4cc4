"""Vectorized BVH traversal over ray wavefronts.

The reference traverses per SIMT thread with a 10-deep node-struct stack
(``extend.wgsl:80-140``).  Here the whole wavefront steps in lockstep
through one masked XLA traversal loop —

* per-lane state is (current node, stack pointer, index stack) held as
  arrays; node fetches are gathers into the flat BVH tables;
* near-child-first ordering with the far child pushed, exactly like the
  reference (extend.wgsl:105-138), so culling behavior matches;
* leaves hold at most ``max_leaf_size`` primitives (builder guarantee),
  tested with a fixed-width masked unroll — no data-dependent inner loop;
* lanes that finish early idle (masked) until the whole wavefront is
  done; the loop is a single ``lax.while_loop`` with no host syncs.

The stack holds *node indices* (int32), not 32-byte node structs — a
64-deep stack costs 256 B/lane instead of the reference's 320 B for
depth 10 (extend.wgsl:38 overflows silently past depth 10; we size for
the actual tree depth and clamp defensively).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops.intersect import T_FAR, T_MIN

STACK_DEPTH = 48
SENTINEL = jnp.int32(-1)


def _slab_test(origin, inv_dir, lo, hi, nearest):
    """Slab AABB test (extend.wgsl:164-183): entry t, or T_FAR if missed."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tmin <= tmax) & (tmax > 0.0) & (tmin <= nearest)
    return jnp.where(hit, tmin, T_FAR)


def _leaf_sphere_t(origin, direction, centers, radii, first, k):
    """Closest valid t for the (first + k)-th primitive, or T_FAR.

    Quadratic identical to the brute-force intersector (extend.wgsl:185-210).
    """
    idx = first + k  # callers may pre-add and pass k=0
    c = centers[idx]
    r = radii[idx]
    oc = origin - c
    a = jnp.sum(direction * direction, axis=-1)
    b = jnp.sum(direction * oc, axis=-1)
    cc = jnp.sum(oc * oc, axis=-1) - r * r
    disc = b * b - a * cc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    t = jnp.where(t1 > T_MIN, t1, jnp.where(t2 > T_MIN, t2, T_FAR))
    return jnp.where(disc >= 0.0, t, T_FAR), idx


def _flat_depth(left_first, prim_count) -> int:
    """Max depth of a flat BVH (host-side; children are adjacent pairs)."""
    import numpy as np

    lf = np.asarray(left_first)
    pc = np.asarray(prim_count)
    depth = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if pc[node] == 0:  # internal
            stack.append((int(lf[node]), d + 1))
            stack.append((int(lf[node]) + 1, d + 1))
    return depth


def intersect_bvh(
    origin, direction,
    centers, radii,
    bvh_min, bvh_max, bvh_left_first, bvh_prim_count,
    max_leaf_size: int = 4,
):
    """Nearest hit via BVH; same contract as ``intersect_bruteforce``.

    Returns (t (N,), sphere_idx (N,) int32, hit (N,) bool) with indices
    into the *BVH-reordered* sphere tables.

    When the node tables are concrete (not jit tracers), the tree depth
    is validated against STACK_DEPTH here — a deeper externally built
    tree would otherwise silently drop far-children on stack overflow.
    Traced callers are covered by prepare_scene's build-time check
    (renderer.py).
    """
    if not isinstance(bvh_prim_count, jax.core.Tracer):
        depth = _flat_depth(bvh_left_first, bvh_prim_count)
        if depth > STACK_DEPTH:
            raise ValueError(
                f"BVH depth {depth} exceeds traversal STACK_DEPTH "
                f"{STACK_DEPTH}; rebuild with a larger stack or a "
                "shallower tree"
            )
    return _intersect_bvh_impl(
        origin, direction, centers, radii,
        bvh_min, bvh_max, bvh_left_first, bvh_prim_count,
        max_leaf_size=max_leaf_size,
    )


def _traverse(leaf_t, origin, direction,
              bvh_min, bvh_max, bvh_left_first, bvh_prim_count,
              max_leaf_size: int):
    """Shared lockstep traversal; ``leaf_t(k_idx)`` returns the k-th
    leaf primitive's closest valid t (T_FAR on miss)."""
    n = origin.shape[0]
    inv_dir = 1.0 / direction

    best_t = jnp.full((n,), T_FAR)
    best_idx = jnp.zeros((n,), jnp.int32)
    node = jnp.zeros((n,), jnp.int32)          # start at root
    sp = jnp.zeros((n,), jnp.int32)
    stack = jnp.full((n, STACK_DEPTH), SENTINEL)
    done = jnp.zeros((n,), bool)
    lanes = jnp.arange(n)

    def cond(state):
        return ~jnp.all(state[0])

    def body(state):
        done, node, sp, stack, best_t, best_idx = state
        lf = bvh_left_first[node]
        pc = bvh_prim_count[node]
        is_leaf = pc > 0

        # --- leaf: masked fixed-width primitive tests ---
        lt, lidx = best_t, best_idx
        for k in range(max_leaf_size):
            idx_k = lf + jnp.int32(k)
            t_k = leaf_t(idx_k)
            valid = is_leaf & ~done & (k < pc) & (t_k < lt)
            lt = jnp.where(valid, t_k, lt)
            lidx = jnp.where(valid, idx_k, lidx)
        best_t = lt
        best_idx = lidx

        # --- internal: order children near-first, push far ---
        left = lf
        right = lf + 1
        t_l = _slab_test(origin, inv_dir, bvh_min[left], bvh_max[left], best_t)
        t_r = _slab_test(origin, inv_dir, bvh_min[right], bvh_max[right], best_t)
        swap = t_l > t_r
        near = jnp.where(swap, right, left)
        far = jnp.where(swap, left, right)
        t_near = jnp.minimum(t_l, t_r)
        t_far = jnp.maximum(t_l, t_r)

        descend = ~is_leaf & ~done & (t_near < best_t)
        push_far = descend & (t_far < best_t)

        # Push far child (clamped if the stack would overflow).
        slot = jnp.minimum(sp, STACK_DEPTH - 1)
        stack = stack.at[lanes, slot].set(
            jnp.where(push_far, far, stack[lanes, slot])
        )
        sp = jnp.where(push_far, jnp.minimum(sp + 1, STACK_DEPTH - 1), sp)

        # Pop for lanes not descending (leaf done, or both children culled).
        need_pop = ~done & ~descend
        can_pop = need_pop & (sp > 0)
        done = done | (need_pop & (sp == 0))
        popped_sp = jnp.maximum(sp - 1, 0)
        popped = stack[lanes, popped_sp]
        node = jnp.where(descend, near, jnp.where(can_pop, popped, node))
        sp = jnp.where(can_pop, popped_sp, sp)
        return done, node, sp, stack, best_t, best_idx

    state = (done, node, sp, stack, best_t, best_idx)
    done, node, sp, stack, best_t, best_idx = jax.lax.while_loop(cond, body, state)
    hit = best_t < T_FAR
    return best_t, best_idx, hit


@functools.partial(jax.jit, static_argnames=("max_leaf_size",))
def _intersect_bvh_impl(
    origin, direction,
    centers, radii,
    bvh_min, bvh_max, bvh_left_first, bvh_prim_count,
    max_leaf_size: int = 4,
):
    def leaf_t(idx):
        t, _ = _leaf_sphere_t(origin, direction, centers, radii, idx,
                              jnp.int32(0))
        return t

    return _traverse(leaf_t, origin, direction, bvh_min, bvh_max,
                     bvh_left_first, bvh_prim_count, max_leaf_size)


@functools.partial(jax.jit, static_argnames=("max_leaf_size",))
def intersect_bvh_triangles(
    origin, direction,
    v0, e1, e2,
    bvh_min, bvh_max, bvh_left_first, bvh_prim_count,
    max_leaf_size: int = 4,
):
    """Nearest triangle hit via BVH (tables in BVH order); same contract
    as ``ops.triangle.intersect_triangles``: (t, tri_idx, hit)."""
    from wavefront_path_tracer_tpu.ops.triangle import triangle_t

    def leaf_t(idx):
        return triangle_t(origin, direction, v0[idx], e1[idx], e2[idx])

    return _traverse(leaf_t, origin, direction, bvh_min, bvh_max,
                     bvh_left_first, bvh_prim_count, max_leaf_size)
