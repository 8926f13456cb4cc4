"""Textures: checker + image UV lookup, across engines."""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.renderer import render
from wavefront_path_tracer_tpu.scene.scene import SceneBuilder, get_scene
from wavefront_path_tracer_tpu.utils.image import rmse

from tests.test_engines import BASE, _cover_camera


def _checker_scene():
    b = SceneBuilder()
    ground = b.lambertian([0.2, 0.3, 0.1],
                          texture=("checker", [0.9, 0.9, 0.9], 10.0))
    b.sphere([0.0, -100.5, -1.0], 100.0, ground)
    b.sphere([0.0, 0.0, -1.2], 0.5, b.lambertian([0.1, 0.2, 0.5]))
    b.sphere([1.0, 0.0, -1.0], 0.5, b.metal([0.8, 0.6, 0.2], 0.1))
    return b.build()


def test_unit_checker_select():
    from wavefront_path_tracer_tpu.ops.texture import checker_select

    # sin products: (+,+,+) -> positive -> first color.
    assert not bool(checker_select(0.1, 0.1, 0.1, 10.0))
    assert bool(checker_select(0.1, 0.1, -0.1, 10.0))
    # scale 0 never selects.
    assert not bool(checker_select(0.5, -0.5, 0.5, 0.0))


def test_unit_sphere_uv():
    from wavefront_path_tracer_tpu.ops.texture import sphere_uv

    n = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                  [-1.0, 0.0, 0.0]], np.float32)
    u, v = sphere_uv(n)
    np.testing.assert_allclose(np.asarray(v), [0.5, 1.0, 0.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(u)[0], 0.5, atol=1e-6)  # +x
    np.testing.assert_allclose(np.asarray(u)[3] % 1.0, 0.0, atol=1e-6)  # -x


def test_unit_image_lookup():
    from wavefront_path_tracer_tpu.ops.texture import image_lookup

    tex = np.zeros((1, 2, 2, 3), np.float32)
    tex[0, 0, 0] = [1, 0, 0]  # top-left (v=1, u=0)
    tex[0, 1, 1] = [0, 1, 0]  # bottom-right (v=0, u=1)
    c = image_lookup(np.asarray(tex), np.zeros((2,), np.int32),
                     np.array([0.1, 0.9]), np.array([0.9, 0.1]))
    np.testing.assert_allclose(np.asarray(c), [[1, 0, 0], [0, 1, 0]])


def test_checker_engines_bit_identical():
    scene = _checker_scene()
    cc = _cover_camera()
    mk = render(scene, cc, BASE.replace(engine="megakernel"))
    wf = render(scene, cc, BASE.replace(engine="wavefront"))
    np.testing.assert_array_equal(mk.accumulated, wf.accumulated)
    # The checker actually fires: both colors visible on the ground.
    assert mk.image.std() > 0.05


def test_image_texture_renders_on_xla_engines():
    scene = get_scene("book_checker")  # includes the UV-pattern sphere
    cc = _cover_camera()
    cfg = BASE.replace(samples_per_pixel=2, samples_per_frame=2)
    mk = render(scene, cc, cfg.replace(engine="megakernel"))
    wf = render(scene, cc, cfg.replace(engine="wavefront"))
    np.testing.assert_array_equal(mk.accumulated, wf.accumulated)
    assert np.isfinite(mk.accumulated).all()


def _image_scene():
    """Small scene dominated by one image-textured sphere (a 16x16
    image)."""
    u = np.linspace(0.0, 1.0, 16)[None, :, None]
    v = np.linspace(0.15, 1.0, 16)[:, None, None]
    img = (np.concatenate([u, 1.0 - u, np.full_like(u, 0.35)], -1)
           * v).astype(np.float32)
    b = SceneBuilder()
    b.sphere([0.0, -100.5, -1.0], 100.0, b.lambertian([0.4, 0.4, 0.4]))
    b.sphere([0.0, 0.0, -1.2], 0.5, b.lambertian([1.0, 1.0, 1.0],
                                                 texture=img))
    b.sphere([1.0, 0.0, -1.0], 0.5, b.metal([0.8, 0.6, 0.2], 0.1))
    return b.build()


def test_image_texture_full_res_gate_64spp():
    """The texture-fidelity acceptance gate: the production
    wavefront/BVH path matches the megakernel oracle's full-res sampler
    to RMSE < 1e-3 at 64 spp (the residual is float ordering between
    the intersectors, which flips a few texel-boundary lookups)."""
    scene = _image_scene()
    cc = _cover_camera()
    cfg = BASE.replace(width=48, height=27, samples_per_pixel=64,
                       samples_per_frame=64)
    mk = render(scene, cc, cfg.replace(engine="megakernel"))
    wf_bvh = render(scene, cc, cfg.replace(engine="wavefront",
                                           intersector="bvh"))
    wf_bf = render(scene, cc, cfg.replace(engine="wavefront",
                                          intersector="bruteforce"))
    assert rmse(wf_bvh.image, mk.image) < 1e-3
    assert rmse(wf_bf.image, mk.image) < 1e-3
