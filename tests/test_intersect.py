"""Sphere intersection: analytic cases + random agreement with a numpy oracle."""

import numpy as np
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops.intersect import (
    T_FAR,
    T_MIN,
    intersect_bruteforce,
    sky_color,
)


def _numpy_nearest(origin, direction, centers, radii):
    """Literal transcription of the reference's sequential nearest-hit loop
    (extend.wgsl:141-210) as an oracle."""
    n = origin.shape[0]
    best_t = np.full(n, 1e30, np.float32)
    best_i = np.zeros(n, np.int32)
    for i in range(centers.shape[0]):
        oc = origin - centers[i]
        a = np.sum(direction * direction, -1)
        b = np.sum(direction * oc, -1)
        c = np.sum(oc * oc, -1) - radii[i] * radii[i]
        disc = b * b - a * c
        ok = disc >= 0
        sq = np.sqrt(np.maximum(disc, 0))
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
        for t in (t1, t2):
            take = ok & (t > 0.001) & (t < best_t)
            best_t = np.where(take, t.astype(np.float32), best_t)
            best_i = np.where(take, i, best_i)
            ok = ok & ~take  # t1 wins over t2 like the reference early-return
    return best_t, best_i, best_t < 1e30


def test_head_on_hit():
    origin = jnp.array([[0.0, 0.0, 0.0]])
    direction = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.array([[0.0, 0.0, -3.0]])
    radii = jnp.array([1.0])
    t, idx, hit = intersect_bruteforce(origin, direction, centers, radii)
    assert bool(hit[0])
    np.testing.assert_allclose(float(t[0]), 2.0, rtol=1e-6)


def test_inside_sphere_uses_far_root():
    # Ray starts at the center of a sphere: near root is negative.
    origin = jnp.array([[0.0, 0.0, -3.0]])
    direction = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.array([[0.0, 0.0, -3.0]])
    radii = jnp.array([1.0])
    t, _, hit = intersect_bruteforce(origin, direction, centers, radii)
    assert bool(hit[0])
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)


def test_epsilon_rejects_self_hit():
    # Origin exactly on the surface pointing away: no hit.
    origin = jnp.array([[0.0, 0.0, -2.0]])
    direction = jnp.array([[0.0, 0.0, 1.0]])
    centers = jnp.array([[0.0, 0.0, -3.0]])
    radii = jnp.array([1.0])
    t, _, hit = intersect_bruteforce(origin, direction, centers, radii)
    assert not bool(hit[0])


def test_miss():
    origin = jnp.array([[0.0, 0.0, 0.0]])
    direction = jnp.array([[0.0, 1.0, 0.0]])
    centers = jnp.array([[0.0, -5.0, 0.0]])
    radii = jnp.array([1.0])
    _, _, hit = intersect_bruteforce(origin, direction, centers, radii)
    assert not bool(hit[0])


def test_random_scene_matches_numpy_oracle():
    rs = np.random.RandomState(3)
    n_rays, n_spheres = 256, 37  # odd sphere count exercises padding
    origin = rs.randn(n_rays, 3).astype(np.float32) * 3
    direction = rs.randn(n_rays, 3).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    centers = rs.randn(n_spheres, 3).astype(np.float32) * 4
    radii = rs.uniform(0.2, 1.5, n_spheres).astype(np.float32)

    t, idx, hit = intersect_bruteforce(
        jnp.asarray(origin), jnp.asarray(direction),
        jnp.asarray(centers), jnp.asarray(radii), sphere_chunk=16,
    )
    wt, wi, wh = _numpy_nearest(origin, direction, centers, radii)
    np.testing.assert_array_equal(np.asarray(hit), wh)
    np.testing.assert_allclose(np.asarray(t)[wh], wt[wh], rtol=2e-5)
    # Indices agree wherever t is not a near-tie.
    close = np.isclose(np.asarray(t), wt, rtol=1e-6)
    agree = (np.asarray(idx) == wi) | ~wh
    assert (agree | ~close).all()


def test_sky_gradient_endpoints():
    up = sky_color(jnp.array([[0.0, 1.0, 0.0]]))
    down = sky_color(jnp.array([[0.0, -1.0, 0.0]]))
    np.testing.assert_allclose(np.asarray(up)[0], [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(down)[0], [1.0, 1.0, 1.0], atol=1e-6)

