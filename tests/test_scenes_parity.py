"""Every built-in sphere scene through both XLA engines and intersectors.

Each case renders one named scene from its default view with the
production wavefront engine and the megakernel oracle under one
intersector.  The engines must agree bit for bit (shared RNG streams
and ops), and the BVH must match brute force up to float ordering.
"""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.renderer import render
from wavefront_path_tracer_tpu.scene import CameraController
from wavefront_path_tracer_tpu.scene.file import apply_camera_dict
from wavefront_path_tracer_tpu.scene.scene import SCENE_CAMERAS, get_scene
from wavefront_path_tracer_tpu.utils.config import RenderConfig
from wavefront_path_tracer_tpu.utils.image import rmse

CFG = RenderConfig(width=48, height=27, samples_per_pixel=2,
                   samples_per_frame=2, max_bounces=8)
SCENES = {
    "book_cover": {},
    "book_bubble": {},
    "book_one_final": {},
    "book_checker": {},
    "cornell_spheres": {},
    "procedural": {"n": 200, "seed": 3},
}


def _camera(name):
    cc = CameraController.book_one_final()
    return apply_camera_dict(cc, SCENE_CAMERAS.get(name, {}))


@pytest.mark.parametrize("intersector", ["bruteforce", "bvh"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_engines_agree(name, intersector):
    scene = get_scene(name, **SCENES[name])
    cc = _camera(name)
    cfg = CFG.replace(intersector=intersector)
    wf = render(scene, cc, cfg.replace(engine="wavefront"))
    mk = render(scene, cc, cfg.replace(engine="megakernel"))
    assert np.isfinite(wf.accumulated).all()
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)
    assert 0.01 < wf.image.mean() < 1.0    # lit, not black or blown out
    if intersector == "bvh":
        bf = render(scene, cc, CFG.replace(engine="wavefront"))
        assert rmse(bf.image, wf.image) < 5e-3
