"""Shared hit resolution: nearest primitive + shading inputs.

One function both XLA engines call, so they stay bit-identical and new
primitive types (triangles) plug in centrally.  Combines the sphere
intersectors (brute force or BVH) with the triangle intersector and
resolves the winner's normal and material.

Normal conventions:
* spheres: outward normal (p - center)/|p - center| — the reference's
  convention (shade.wgsl:93); the dielectric BSDF does its own
  inside-flip.
* triangles: geometric normal for dielectrics (winding defines
  outside); flipped-to-face-the-ray for diffuse/metal (open meshes have
  no inside).
"""

from __future__ import annotations

import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops.intersect import intersect_bruteforce
from wavefront_path_tracer_tpu.ops.triangle import intersect_triangles
from wavefront_path_tracer_tpu.scene.scene import DIELECTRIC


def _intersect_spheres(origin, direction, scene_arrays, config):
    if config.intersector == "bvh":
        from wavefront_path_tracer_tpu.ops.bvh_traverse import intersect_bvh
        from wavefront_path_tracer_tpu.scene.bvh import MAX_LEAF_SIZE

        # max_leaf_size must match the builder's cap or the traversal's
        # fixed-width leaf unroll would skip primitives.
        return intersect_bvh(
            origin, direction,
            scene_arrays["centers"], scene_arrays["radii"],
            scene_arrays["bvh_min"], scene_arrays["bvh_max"],
            scene_arrays["bvh_left_first"], scene_arrays["bvh_prim_count"],
            max_leaf_size=MAX_LEAF_SIZE,
        )
    return intersect_bruteforce(
        origin, direction, scene_arrays["centers"], scene_arrays["radii"],
        sphere_chunk=min(config.sphere_chunk, scene_arrays["centers"].shape[0]),
    )


def intersect_and_resolve(origin, direction, scene_arrays, config):
    """Nearest hit over all primitive types + shading inputs.

    Returns (t, hit, normal (N,3), albedo (N,3), fuzz, refract_idx,
    mat_type) — attribute values are garbage on non-hit lanes (callers
    mask by ``hit``).
    """
    t, sphere_idx, hit = _intersect_spheres(origin, direction, scene_arrays, config)

    # Sphere shading inputs.
    center = scene_arrays["centers"][sphere_idx]
    p = origin + t[:, None] * direction
    nvec = p - center
    # Inside-out spheres (negative radius, the RTIOW hollow-bubble
    # trick) flip the normal: (p - c)/r, not /|p - c|.
    nvec = nvec * jnp.sign(scene_arrays["radii"][sphere_idx])[:, None]
    normal = nvec / jnp.linalg.norm(nvec, axis=-1, keepdims=True)
    albedo = scene_arrays["albedo"][sphere_idx]
    fuzz = scene_arrays["fuzz"][sphere_idx]
    refract = scene_arrays["refract_idx"][sphere_idx]
    mat = scene_arrays["mat_type"][sphere_idx]

    if "tex_kind" in scene_arrays:
        from wavefront_path_tracer_tpu.ops.texture import resolve_albedo

        albedo = resolve_albedo(
            albedo,
            scene_arrays["tex_kind"][sphere_idx],
            scene_arrays["tex_albedo2"][sphere_idx],
            scene_arrays["tex_scale"][sphere_idx],
            scene_arrays["tex_id"][sphere_idx],
            p, normal, scene_arrays.get("tex_data"),
        )

    if "tri_v0" in scene_arrays:
        if "tri_bvh_min" in scene_arrays:
            from wavefront_path_tracer_tpu.ops.bvh_traverse import (
                intersect_bvh_triangles,
            )
            from wavefront_path_tracer_tpu.scene.bvh import MAX_LEAF_SIZE

            t_t, tri_idx, hit_t = intersect_bvh_triangles(
                origin, direction,
                scene_arrays["tri_v0"], scene_arrays["tri_e1"],
                scene_arrays["tri_e2"],
                scene_arrays["tri_bvh_min"], scene_arrays["tri_bvh_max"],
                scene_arrays["tri_bvh_left_first"],
                scene_arrays["tri_bvh_prim_count"],
                max_leaf_size=MAX_LEAF_SIZE,
            )
        else:
            t_t, tri_idx, hit_t = intersect_triangles(
                origin, direction,
                scene_arrays["tri_v0"], scene_arrays["tri_e1"],
                scene_arrays["tri_e2"],
            )
        use_tri = t_t < t
        t = jnp.where(use_tri, t_t, t)
        hit = hit | hit_t

        n_geo = scene_arrays["tri_normal"][tri_idx]
        tri_mat = scene_arrays["tri_mat_type"][tri_idx]
        toward = jnp.sum(direction * n_geo, axis=-1) > 0.0
        n_facing = jnp.where(toward[:, None], -n_geo, n_geo)
        n_tri = jnp.where((tri_mat == DIELECTRIC)[:, None], n_geo, n_facing)

        normal = jnp.where(use_tri[:, None], n_tri, normal)
        albedo = jnp.where(use_tri[:, None],
                           scene_arrays["tri_albedo"][tri_idx], albedo)
        fuzz = jnp.where(use_tri, scene_arrays["tri_fuzz"][tri_idx], fuzz)
        refract = jnp.where(use_tri,
                            scene_arrays["tri_refract"][tri_idx], refract)
        mat = jnp.where(use_tri, tri_mat, mat)

    return t, hit, normal, albedo, fuzz, refract, mat
