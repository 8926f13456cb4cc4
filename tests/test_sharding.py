"""Multi-chip rendering over the 8-virtual-device CPU mesh."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wavefront_path_tracer_tpu.parallel.sharding import (
    make_mesh,
    render_samples_sharded,
)
from wavefront_path_tracer_tpu.renderer import prepare_scene, render
from wavefront_path_tracer_tpu.scene import CameraController
from wavefront_path_tracer_tpu.utils.config import RenderConfig


def _camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.defocus_angle_deg = 0.0
    return cc


CFG = RenderConfig(
    width=64, height=32, samples_per_pixel=4, samples_per_frame=4,
    max_bounces=8, engine="wavefront",
)


def _sharded(scene, cc, cfg, mesh):
    arrays = prepare_scene(scene, cfg)
    view = jnp.asarray(cc.view_matrix())
    inv_proj = jnp.asarray(cc.inverse_projection(cfg.width, cfg.height))
    rad = render_samples_sharded(
        mesh, arrays, cc.gpu_camera(), view, inv_proj, cfg,
        jnp.uint32(cfg.frame), jnp.uint32(0), cfg.samples_per_pixel,
    )
    return np.asarray(rad)


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_tile_sharding_matches_single_device(book_cover_scene):
    cc = _camera()
    single = render(book_cover_scene, cc, CFG)
    mesh = make_mesh(8, sample_axis=1)
    rad = _sharded(book_cover_scene, cc, CFG, mesh)
    # Pure pixel DP: no reductions reordered => bit-identical.
    np.testing.assert_array_equal(rad, single.accumulated.reshape(-1, 3))


def test_sample_sharding_matches(book_cover_scene):
    cc = _camera()
    single = render(book_cover_scene, cc, CFG)
    mesh = make_mesh(8, sample_axis=4)
    rad = _sharded(book_cover_scene, cc, CFG, mesh)
    # Sample psum reorders float adds: allclose, not bit-equal.
    np.testing.assert_allclose(
        rad, single.accumulated.reshape(-1, 3), rtol=1e-5, atol=1e-6
    )


def test_megakernel_engine_shards_too(book_cover_scene):
    cc = _camera()
    cfg = CFG.replace(engine="megakernel")
    single = render(book_cover_scene, cc, cfg)
    mesh = make_mesh(4, sample_axis=2)
    rad = _sharded(book_cover_scene, cc, cfg, mesh)
    np.testing.assert_allclose(
        rad, single.accumulated.reshape(-1, 3), rtol=1e-5, atol=1e-6
    )


def test_indivisible_pixels_rejected(book_cover_scene):
    cc = _camera()
    cfg = CFG.replace(width=9, height=7)  # 63 pixels not divisible by 8
    arrays = prepare_scene(book_cover_scene, cfg)
    mesh = make_mesh(8, sample_axis=1)
    with pytest.raises(AssertionError, match="tiles"):
        render_samples_sharded(
            mesh, arrays, cc.gpu_camera(),
            jnp.asarray(cc.view_matrix()),
            jnp.asarray(cc.inverse_projection(cfg.width, cfg.height)),
            cfg, jnp.uint32(0), jnp.uint32(0), cfg.samples_per_pixel,
        )


def test_multihost_dryrun():
    """Two CPU processes x 4 virtual devices: the multi-host mesh path
    (parallel/multihost.py) renders tile bands bit-identical to a
    single-process render."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(__file__))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    script = os.path.join(os.path.dirname(__file__), "multihost_dryrun.py")
    procs = [
        subprocess.Popen([_sys.executable, script, str(i), str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"process {i}: OK" in out


def test_sharded_respects_clamp(book_cover_scene):
    """Config knobs (here the firefly clamp) flow through the sharded
    path identically to single-device rendering."""
    cfg = CFG.replace(clamp=0.2)
    mesh = make_mesh(8, sample_axis=1)   # pure tile DP: bit-identical
    sharded = _sharded(book_cover_scene, _camera(), cfg, mesh)
    single = render(book_cover_scene, _camera(), cfg)
    np.testing.assert_array_equal(
        sharded, single.accumulated.reshape(-1, 3))
    assert (sharded <= cfg.samples_per_pixel * 0.2 + 1e-5).all()


@pytest.mark.parametrize("tiles,samples", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("intersector", ["bruteforce", "bvh"])
@pytest.mark.parametrize("engine", ["wavefront", "megakernel"])
def test_sharded_xla_matches_single(book_cover_scene, engine, intersector,
                                    tiles, samples):
    """Both XLA engines and both intersectors under shard_map on four
    devices: a tiles-only mesh is bit-identical to one device; a mesh
    with a samples axis reorders the psum's float adds."""
    cc = _camera()
    cfg = CFG.replace(engine=engine, intersector=intersector)
    single = render(book_cover_scene, cc, cfg).accumulated.reshape(-1, 3)
    mesh = make_mesh(4, sample_axis=samples)
    assert dict(mesh.shape) == {"tiles": tiles, "samples": samples}
    rad = _sharded(book_cover_scene, cc, cfg, mesh)
    if samples == 1:
        np.testing.assert_array_equal(rad, single)
    else:
        np.testing.assert_allclose(rad, single, rtol=1e-5, atol=1e-6)
