"""Engine parity: megakernel oracle vs. wavefront engine.

The RNG stream contract (per-(pixel,sample,bounce) streams) makes the
engines bit-identical on the same backend — the strongest possible form
of the BASELINE 'RMSE vs oracle' gate.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from wavefront_path_tracer_tpu.renderer import Renderer, prepare_scene, render
from wavefront_path_tracer_tpu.scene import CameraController, book_cover
from wavefront_path_tracer_tpu.utils.config import RenderConfig
from wavefront_path_tracer_tpu.utils.image import rmse


def _cover_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 20.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


BASE = RenderConfig(
    width=64, height=36, samples_per_pixel=4, samples_per_frame=4,
    max_bounces=12, intersector="bruteforce",
)


def _render(scene, cc, cfg):
    return render(scene, cc, cfg)


@pytest.fixture(scope="module")
def oracle_result(book_cover_scene):
    return _render(book_cover_scene, _cover_camera(), BASE.replace(engine="megakernel"))


def test_oracle_image_sane(oracle_result):
    img = oracle_result.image
    assert img.shape == (36, 64, 3)
    assert np.isfinite(img).all()
    assert 0.05 < img.mean() < 1.0  # lit scene, not black/blown out
    # The view contains both sky-lit (bluish) and ground (yellowish,
    # albedo 0.8/0.8/0.0 -> blue-suppressed) pixels.
    blue_heavy = (img[..., 2] > img[..., 0] + 0.05).mean()
    yellow_heavy = (img[..., 0] > img[..., 2] + 0.05).mean()
    assert blue_heavy > 0.05 and yellow_heavy > 0.05


def test_wavefront_bit_identical_to_oracle(book_cover_scene, oracle_result):
    wf = _render(book_cover_scene, _cover_camera(), BASE.replace(engine="wavefront"))
    np.testing.assert_array_equal(wf.accumulated, oracle_result.accumulated)


def test_wavefront_chunked_matches(book_cover_scene, oracle_result):
    wf = _render(
        book_cover_scene, _cover_camera(),
        BASE.replace(engine="wavefront", ray_chunk=512),
    )
    np.testing.assert_array_equal(wf.accumulated, oracle_result.accumulated)


def test_bvh_engines_bit_identical(book_cover_scene):
    """Same intersector => wavefront and megakernel stay bit-identical."""
    cfg = BASE.replace(intersector="bvh")
    mk = _render(book_cover_scene, _cover_camera(), cfg.replace(engine="megakernel"))
    wf = _render(book_cover_scene, _cover_camera(), cfg.replace(engine="wavefront"))
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)


def test_bvh_vs_bruteforce_statistical(book_cover_scene):
    """Across intersectors only float round-off separates renders; a
    handful of near-tie paths may diverge, so compare display images
    at noise tolerance."""
    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8)
    bf = _render(book_cover_scene, _cover_camera(), cfg)
    bv = _render(book_cover_scene, _cover_camera(),
                 cfg.replace(intersector="bvh"))
    assert rmse(bf.image, bv.image) < 5e-3


def test_megakernel_ray_chunking_matches(book_cover_scene, oracle_result):
    mk = _render(
        book_cover_scene, _cover_camera(),
        BASE.replace(engine="megakernel", ray_chunk=256),
    )
    np.testing.assert_array_equal(mk.accumulated, oracle_result.accumulated)


def test_progressive_accumulation_equals_batch(book_cover_scene):
    cc = _cover_camera()
    batched = _render(book_cover_scene, cc, BASE.replace(engine="wavefront"))
    progressive = _render(
        book_cover_scene, cc,
        BASE.replace(engine="wavefront", samples_per_frame=1),
    )
    assert progressive.samples == batched.samples == 4
    np.testing.assert_allclose(
        progressive.accumulated, batched.accumulated, rtol=1e-5, atol=1e-6
    )


def test_accumulation_restart_on_camera_change(book_cover_scene):
    r = Renderer(book_cover_scene, _cover_camera(), BASE.replace(engine="wavefront"))
    r.render_frame()
    assert r.progress.accumulated_samples == 4
    r.camera_changed()
    assert r.progress.accumulated_samples == 0
    assert (r._accum == 0).all()


def test_drain_threshold_biases_but_runs(book_cover_scene, oracle_result):
    wf = _render(
        book_cover_scene, _cover_camera(),
        BASE.replace(engine="wavefront", drain_threshold=64),
    )
    assert np.isfinite(wf.accumulated).all()
    # Early drain loses energy relative to exact termination.
    assert wf.accumulated.sum() <= oracle_result.accumulated.sum() + 1e-3


def test_material_split_identical(book_cover_scene, oracle_result):
    """Per-material shade split (reference TODO) matches the branchless
    shade path bit-for-bit: same draws, same math, different
    partitioning."""
    wf = _render(
        book_cover_scene, _cover_camera(),
        BASE.replace(engine="wavefront", material_split=True),
    )
    np.testing.assert_array_equal(wf.accumulated, oracle_result.accumulated)


def test_energy_conservation(book_cover_scene, oracle_result):
    """Property: with albedos <= 1 and sky radiance <= 1, per-sample
    radiance is bounded by 1 per channel (multiplicative throughput
    never amplifies; SURVEY.md §4's suggested property test)."""
    avg = oracle_result.accumulated / oracle_result.samples
    assert (avg <= 1.0 + 1e-5).all()
    assert (avg >= 0.0).all()


def test_renders_are_deterministic(book_cover_scene):
    """Two renders of the same config are bit-identical — the
    reproducibility the reference cannot offer (its queue order, and
    hence its shade RNG, is atomics-nondeterministic; SURVEY.md §8
    quirk 5)."""
    cc = _cover_camera()
    a = _render(book_cover_scene, cc, BASE.replace(engine="wavefront"))
    b = _render(book_cover_scene, cc, BASE.replace(engine="wavefront"))
    np.testing.assert_array_equal(a.accumulated, b.accumulated)


def test_bounce_histogram(book_cover_scene):
    """Queue occupancy: monotone non-increasing, starts at all pixels."""
    import jax.numpy as jnp

    from wavefront_path_tracer_tpu.models.wavefront import bounce_histogram
    from wavefront_path_tracer_tpu.renderer import prepare_scene

    cc = _cover_camera()
    cfg = BASE
    arrays = prepare_scene(book_cover_scene, cfg)
    hist = np.asarray(bounce_histogram(
        arrays, cc.gpu_camera(),
        jnp.asarray(cc.view_matrix()),
        jnp.asarray(cc.inverse_projection(cfg.width, cfg.height)),
        cfg, jnp.uint32(0), jnp.uint32(0),
    ))
    assert hist.shape == (cfg.max_bounces,)
    assert hist[0] == cfg.num_pixels
    assert (np.diff(hist) <= 0).all()
    # In this downward-looking view every primary ray hits the ground
    # dome, but paths die off over the bounce budget.
    assert hist[-1] < hist[0]


def test_bvh_on_cpu_backend_does_not_warn(book_cover_scene):
    """The BVH is the production intersector: a BVH renderer is
    constructed without warnings."""
    import warnings as _warnings

    cc = _cover_camera()
    with _warnings.catch_warnings():
        _warnings.simplefilter("error", RuntimeWarning)
        Renderer(book_cover_scene, cc, BASE.replace(
            engine="wavefront", intersector="bvh"))


def test_negative_radius_bubble_parity():
    """Negative-radius (inside-out) spheres through every engine
    (the hollow-bubble trick must stay a real, visible sphere).
    book_bubble is book_cover with the hollow bubble as radius -0.4
    instead of inverted IOR.  wavefront must stay bit-identical to the
    megakernel; the BVH intersector (|r| AABBs, far-root retention for
    the inside-out sphere) within the usual summation-order band."""
    from wavefront_path_tracer_tpu.scene import book_bubble

    scene = book_bubble()
    cc = _cover_camera()
    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8)
    mk = _render(scene, cc, cfg.replace(engine="megakernel"))
    assert np.isfinite(mk.accumulated).all()
    wf = _render(scene, cc, cfg.replace(engine="wavefront"))
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)
    bv = _render(scene, cc, cfg.replace(engine="wavefront",
                                        intersector="bvh"))
    assert rmse(bv.image, mk.image) < 2e-3
    bm = _render(scene, cc, cfg.replace(engine="megakernel",
                                        intersector="bvh"))
    np.testing.assert_array_equal(bm.accumulated, bv.accumulated)
    # The bubble is visibly there: the render differs from a
    # solid-glass variant (guards against the inside-out sphere being
    # silently skipped by elision or the sign-only inv_r path).
    from wavefront_path_tracer_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.sphere([0.0, -100.5, -1.0], 100.0, b.lambertian([0.8, 0.8, 0.0]))
    b.sphere([0.0, 0.0, -1.2], 0.5, b.lambertian([0.1, 0.2, 0.5]))
    b.sphere([1.0, 0.0, -1.0], 0.5, b.metal([0.8, 0.6, 0.2], 1.0))
    b.sphere([-1.0, 0.0, -1.0], 0.5, b.dielectric(1.50))
    solid = _render(b.build(), cc, cfg.replace(engine="megakernel"))
    assert rmse(solid.image, mk.image) > 1e-3
