"""Render properties held across the two XLA engines and both intersectors.

Every case renders the production wavefront engine and the megakernel
oracle with the same intersector.  They share per-(pixel, sample,
bounce) RNG streams and the hit/shade ops, so on one backend they must
agree bit for bit; the property-specific checks then pin what each case
is about (padding, thin lens, far-from-origin conditioning, inside-out
spheres, triangles, textures, progressive batching, ray accounting).
"""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.renderer import Renderer, render
from wavefront_path_tracer_tpu.utils.image import rmse

from tests.test_engines import BASE, _cover_camera

INTERSECTORS = ["bruteforce", "bvh"]


def _both(scene, cc, cfg, triangles=None):
    """(wavefront, megakernel) results; asserts they are bit-identical."""
    wf = render(scene, cc, cfg.replace(engine="wavefront"),
                triangles=triangles)
    mk = render(scene, cc, cfg.replace(engine="megakernel"),
                triangles=triangles)
    assert np.isfinite(wf.accumulated).all()
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)
    return wf, mk


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_nonsquare_padding(book_cover_scene, intersector):
    """100x27 = 2700 pixels with 512-ray chunks: the wavefront queue and
    the megakernel chunk grid both pad, and padded lanes must neither
    crash nor leak radiance."""
    cfg = BASE.replace(width=100, height=27, samples_per_pixel=2,
                       samples_per_frame=2, intersector=intersector,
                       ray_chunk=512)
    wf, _ = _both(book_cover_scene, _cover_camera(), cfg)
    assert wf.accumulated.shape == (27, 100, 3)
    unchunked = render(book_cover_scene, _cover_camera(),
                       cfg.replace(engine="megakernel", ray_chunk=0))
    np.testing.assert_array_equal(wf.accumulated, unchunked.accumulated)


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_defocus_blur(book_cover_scene, intersector):
    """Thin-lens path: lens sampling is shared, and the blur is real
    (the image differs from the pinhole render)."""
    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8,
                       intersector=intersector)
    cam = _cover_camera()
    cam.defocus_angle_deg = 10.0
    cam.focus_distance = 3.4
    wf, _ = _both(book_cover_scene, cam, cfg)
    pinhole = render(book_cover_scene, _cover_camera(),
                     cfg.replace(engine="wavefront"))
    assert rmse(wf.image, pinhole.image) > 1e-3


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_far_from_origin_scene(intersector):
    """A scene translated thousands of units from the origin renders the
    same picture: the quadratic works on o - c, so its error does not
    grow with |c|^2 (no silhouette speckle or self-intersection acne)."""
    from wavefront_path_tracer_tpu.scene.scene import book_cover

    off = np.array([2000.0, -1000.0, 3000.0], np.float32)
    scene = book_cover()
    moved = scene._replace(centers=scene.centers + off)
    cc = _cover_camera()
    cam = cc.camera
    cc.camera = cam.look_at(np.asarray(cam.position) + off,
                            np.array([0.0, 0.0, -1.0]) + off)
    cfg = BASE.replace(samples_per_pixel=2, samples_per_frame=2,
                       intersector=intersector)
    far, _ = _both(moved, cc, cfg)
    near = render(scene, _cover_camera(), cfg.replace(engine="wavefront"))
    # Ray origins are f32-quantized to ~|o|*eps here, so a few paths
    # diverge; a conditioning failure would spoil most pixels.
    assert abs(far.accumulated.mean() - near.accumulated.mean()) < 2e-2
    diff = np.abs(far.image - near.image).max(axis=-1)
    assert (diff > 0.05).mean() < 0.05


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_negative_radius(intersector):
    """The RTIOW hollow bubble (radius -0.4 inside a glass shell) is hit
    and visibly differs from a solid glass sphere."""
    from wavefront_path_tracer_tpu.scene import SceneBuilder, book_bubble

    cc = _cover_camera()
    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8,
                       intersector=intersector)
    wf, _ = _both(book_bubble(), cc, cfg)
    b = SceneBuilder()
    b.sphere([0.0, -100.5, -1.0], 100.0, b.lambertian([0.8, 0.8, 0.0]))
    b.sphere([0.0, 0.0, -1.2], 0.5, b.lambertian([0.1, 0.2, 0.5]))
    b.sphere([1.0, 0.0, -1.0], 0.5, b.metal([0.8, 0.6, 0.2], 1.0))
    b.sphere([-1.0, 0.0, -1.0], 0.5, b.dielectric(1.50))
    solid = render(b.build(), cc, cfg.replace(engine="wavefront"))
    assert rmse(solid.image, wf.image) > 1e-3


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_triangles_match_oracle(intersector):
    """Terrain mesh: engines agree, and the intersector under test
    matches the brute-force oracle up to float ordering."""
    from wavefront_path_tracer_tpu.scene.mesh import mesh_terrain_scene

    scene, tris = mesh_terrain_scene(n_quads=5, seed=2)
    cfg = BASE.replace(samples_per_pixel=2, samples_per_frame=2,
                       intersector=intersector)
    wf, _ = _both(scene, _cover_camera(), cfg, triangles=tris)
    oracle = render(scene, _cover_camera(),
                    cfg.replace(engine="megakernel", intersector="bruteforce"),
                    triangles=tris)
    assert rmse(wf.image, oracle.image) < 5e-3


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_checker_texture(intersector):
    """Checker-textured ground: both checker colors reach the image."""
    from tests.test_texture import _checker_scene

    wf, _ = _both(_checker_scene(), _cover_camera(),
                  BASE.replace(intersector=intersector))
    assert wf.image.std() > 0.05


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_image_texture(intersector):
    """Image-textured sphere, sampled at full resolution: agrees with the
    brute-force oracle and is not the untextured white sphere."""
    from tests.test_texture import _image_scene

    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8,
                       intersector=intersector)
    scene = _image_scene()
    wf, _ = _both(scene, _cover_camera(), cfg)
    plain = render(scene._replace(tex_kind=None, tex_data=None),
                   _cover_camera(), cfg.replace(engine="wavefront"))
    assert rmse(plain.image, wf.image) > 1e-2


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_progressive_equals_single_batch(book_cover_scene, intersector):
    """One-sample frames accumulate the same radiance as one 4-sample
    batch, on both engines (sample_base keys the streams)."""
    cfg = BASE.replace(intersector=intersector)
    for engine in ("wavefront", "megakernel"):
        batched = render(book_cover_scene, _cover_camera(),
                         cfg.replace(engine=engine))
        progressive = render(book_cover_scene, _cover_camera(),
                             cfg.replace(engine=engine, samples_per_frame=1))
        assert progressive.samples == batched.samples == 4
        np.testing.assert_allclose(progressive.accumulated,
                                   batched.accumulated, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("intersector", INTERSECTORS)
def test_rays_accounting(book_cover_scene, intersector):
    """The Mrays/s numerator counts live rays entering extend: equal on
    both engines, and equal to the wavefront queue occupancy summed
    over bounces (bounce_histogram) for a one-sample frame."""
    import jax.numpy as jnp

    from wavefront_path_tracer_tpu.models.wavefront import bounce_histogram

    cc = _cover_camera()
    cfg = BASE.replace(samples_per_pixel=1, samples_per_frame=1,
                       intersector=intersector)
    rays = {}
    for engine in ("wavefront", "megakernel"):
        ren = Renderer(book_cover_scene, cc, cfg.replace(engine=engine))
        rays[engine] = ren.render_frame().rays_traced
    assert rays["wavefront"] == rays["megakernel"]
    hist = bounce_histogram(
        ren.scene_arrays, cc.gpu_camera(), jnp.asarray(cc.view_matrix()),
        jnp.asarray(cc.inverse_projection(cfg.width, cfg.height)), cfg,
        jnp.uint32(0), jnp.uint32(0))
    assert rays["wavefront"] == float(np.asarray(hist).sum())
    assert cfg.num_pixels <= rays["wavefront"] <= (
        cfg.num_pixels * cfg.max_bounces)
