"""Per-sample radiance clamp (firefly suppression)."""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.renderer import render

from tests.test_engines import BASE, _cover_camera


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_clamp_bounds_samples(book_cover_scene, engine):
    """With clamp C every per-sample contribution is <= C, so the
    spp-sample accumulation is <= C * spp."""
    cfg = BASE.replace(engine=engine, clamp=0.25,
                       samples_per_pixel=4, samples_per_frame=4)
    r = render(book_cover_scene, _cover_camera(), cfg)
    assert (r.accumulated <= 4 * 0.25 + 1e-5).all()
    assert r.accumulated.mean() > 0.01   # not all clamped to nothing
    # And the clamp actually engages: the unclamped render exceeds it.
    off = render(book_cover_scene, _cover_camera(), cfg.replace(clamp=0.0))
    assert off.accumulated.max() > r.accumulated.max()


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_huge_clamp_is_identity(book_cover_scene, engine):
    cfg = BASE.replace(engine=engine, samples_per_pixel=2,
                       samples_per_frame=2)
    off = render(book_cover_scene, _cover_camera(), cfg)
    big = render(book_cover_scene, _cover_camera(), cfg.replace(clamp=1e9))
    np.testing.assert_array_equal(off.accumulated, big.accumulated)


def test_clamp_validation():
    with pytest.raises(ValueError):
        BASE.replace(clamp=-1.0)


def test_adaptive_stop(book_cover_scene):
    """stop_delta ends the progressive loop once the display image
    stops changing; the SPP budget stays the hard cap."""
    from wavefront_path_tracer_tpu.renderer import Renderer

    cfg = BASE.replace(engine="megakernel", samples_per_pixel=64,
                       samples_per_frame=4, stop_delta=0.02)
    ren = Renderer(book_cover_scene, _cover_camera(), cfg)
    r = ren.render()
    assert ren.last_delta is not None and ren.last_delta < 0.02
    assert 8 <= r.samples < 64          # stopped early, after >= 2 batches

    full = render(book_cover_scene, _cover_camera(),
                  cfg.replace(stop_delta=0.0))
    assert full.samples == 64
    # The early-stopped image is already close to the full render.
    assert np.abs(r.image - full.image).mean() < 0.05
