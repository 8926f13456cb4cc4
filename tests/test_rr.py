"""Russian roulette (rr_start_bounce): unbiasedness + engine parity."""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.renderer import render

from tests.test_engines import BASE, _cover_camera


def test_rr_unbiased_mean(book_cover_scene):
    """Roulette is an unbiased estimator: mean radiance matches the
    rr-off render within Monte-Carlo noise (the variance rises for the
    killed-path tail, so the gate is on the mean, not per-pixel)."""
    cfg = BASE.replace(engine="megakernel", samples_per_pixel=64,
                       samples_per_frame=64)
    off = render(book_cover_scene, _cover_camera(), cfg)
    on = render(book_cover_scene, _cover_camera(),
                cfg.replace(rr_start_bounce=2))
    m_off = float(np.asarray(off.accumulated).mean())
    m_on = float(np.asarray(on.accumulated).mean())
    assert abs(m_on - m_off) / m_off < 0.02


def test_rr_inactive_is_identical(book_cover_scene):
    """A compiled-in roulette that never activates (start bounce past
    the bounce cap) is bit-identical to the rr-off render: the draw is
    independently salted, so the scatter/reflectance streams are
    untouched and no survivor's throughput is rescaled."""
    cfg = BASE.replace(engine="megakernel")
    off = render(book_cover_scene, _cover_camera(), cfg)
    on = render(book_cover_scene, _cover_camera(),
                cfg.replace(rr_start_bounce=cfg.max_bounces + 1))
    np.testing.assert_array_equal(off.accumulated, on.accumulated)


def test_rr_negative_rejected():
    """Negative start bounces are rejected at config construction (the
    engines would otherwise silently disagree: int compare vs u32 cast)."""
    with pytest.raises(ValueError, match="rr_start_bounce"):
        BASE.replace(rr_start_bounce=-1)


def test_rr_engines_agree(book_cover_scene):
    """megakernel and wavefront share the roulette stream bit-exactly;
    the BVH intersector matches statistically (its float ordering
    differs, so a few near-tie paths diverge)."""
    cfg = BASE.replace(samples_per_pixel=4, samples_per_frame=4,
                       rr_start_bounce=2, rr_floor=0.3)
    mk = render(book_cover_scene, _cover_camera(),
                cfg.replace(engine="megakernel"))
    wf = render(book_cover_scene, _cover_camera(),
                cfg.replace(engine="wavefront"))
    np.testing.assert_array_equal(mk.accumulated, wf.accumulated)
    bv = render(book_cover_scene, _cover_camera(),
                cfg.replace(engine="wavefront", intersector="bvh"))
    assert np.isfinite(bv.accumulated).all()
    diff = np.abs(bv.accumulated - mk.accumulated).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.05
