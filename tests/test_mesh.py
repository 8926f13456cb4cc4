"""Triangle meshes: intersection, OBJ loading, end-to-end renders."""

import numpy as np
import jax.numpy as jnp
import pytest

from wavefront_path_tracer_tpu.ops.triangle import (
    intersect_triangles,
    triangle_normals,
)
from wavefront_path_tracer_tpu.renderer import render
from wavefront_path_tracer_tpu.scene import CameraController
from wavefront_path_tracer_tpu.scene.mesh import (
    MeshSceneBuilder,
    load_obj,
    mesh_demo_scene,
)
from wavefront_path_tracer_tpu.utils.config import RenderConfig


def test_single_triangle_hit_miss():
    v0 = jnp.array([[-1.0, -1.0, -3.0]])
    e1 = jnp.array([[2.0, 0.0, 0.0]])   # v1 = (1,-1,-3)
    e2 = jnp.array([[0.0, 2.0, 0.0]])   # v2 = (-1,1,-3)
    origin = jnp.array([[0.0, -0.5, 0.0], [0.0, 0.9, 0.0], [0.0, -0.5, 0.0]])
    direction = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    t, idx, hit = intersect_triangles(origin, direction, v0, e1, e2)
    assert bool(hit[0]) and float(t[0]) == pytest.approx(3.0)
    assert not bool(hit[1])  # outside the hypotenuse edge (u+v > 1)
    assert not bool(hit[2])  # behind the ray
    # Back-face hit works (two-sided).
    t, _, hit = intersect_triangles(
        jnp.array([[0.0, -0.5, -6.0]]), jnp.array([[0.0, 0.0, 1.0]]), v0, e1, e2
    )
    assert bool(hit[0]) and float(t[0]) == pytest.approx(3.0)


def test_triangle_normals_unit_and_ccw():
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    n = np.asarray(triangle_normals(e1, e2))
    np.testing.assert_allclose(n[0], [0.0, 0.0, 1.0], atol=1e-7)


def test_load_obj_with_mtl(tmp_path):
    (tmp_path / "scene.mtl").write_text(
        "newmtl glass\nNi 1.5\nnewmtl mirror\nKs 0.9 0.9 0.9\nNs 900\n"
        "newmtl wall\nKd 0.2 0.4 0.6\n"
    )
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "usemtl wall\nf 1 2 3 4\n"      # quad -> 2 tris
        "usemtl glass\nf 1 2 3\n"
        "usemtl mirror\nf -3 -2 -1\n"   # negative indices
    )
    b = load_obj(str(tmp_path / "scene.obj"))
    scene, tris = b.build_mesh_scene()
    assert tris.num_triangles == 4
    assert tris.mat_type[0] == 0 and tris.mat_type[1] == 0  # wall quad
    assert tris.mat_type[2] == 2 and tris.refract_idx[2] == np.float32(1.5)
    assert tris.mat_type[3] == 1  # mirror
    np.testing.assert_allclose(tris.v0[3], [1.0, 0.0, 0.0])  # -3 -> vertex 2


def _mesh_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 2.0, 6.0], [0.0, 0.8, 0.0])
    cc.vfov_deg = 40.0
    cc.defocus_angle_deg = 0.0
    return cc


CFG = RenderConfig(width=64, height=36, samples_per_pixel=4,
                   samples_per_frame=4, max_bounces=8)


def test_mesh_scene_renders_and_engines_agree():
    scene, tris = mesh_demo_scene()
    cc = _mesh_camera()
    mk = render(scene, cc, CFG.replace(engine="megakernel"), triangles=tris)
    wf = render(scene, cc, CFG.replace(engine="wavefront"), triangles=tris)
    assert np.isfinite(mk.accumulated).all()
    assert mk.image.mean() > 0.05
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)
    # Triangles actually matter: without them the image differs.
    no_tris = render(scene, cc, CFG.replace(engine="megakernel"))
    assert not np.allclose(no_tris.accumulated, mk.accumulated)


def test_triangles_with_bvh_spheres():
    """Triangles compose with the BVH sphere intersector too."""
    scene, tris = mesh_demo_scene()
    cc = _mesh_camera()
    cfg = CFG.replace(intersector="bvh")
    bf = render(scene, cc, CFG.replace(engine="wavefront"), triangles=tris)
    bv = render(scene, cc, cfg.replace(engine="wavefront"), triangles=tris)
    from wavefront_path_tracer_tpu.utils.image import rmse

    assert rmse(bf.image, bv.image) < 5e-3


def test_gen_obj_roundtrip_and_fused_parity(tmp_path):
    """Procedural OBJ (examples/gen_obj.py) -> load_obj -> the
    production wavefront/BVH render matches the megakernel oracle.
    Small-scale twin of the 50k-triangle benchmark config (BASELINE
    config 5)."""
    import subprocess
    import sys

    from wavefront_path_tracer_tpu.utils.image import rmse

    obj = tmp_path / "knot.obj"
    out = subprocess.run(
        [sys.executable, "examples/gen_obj.py", "--shape", "knot",
         "--tris", "600", "--out", str(obj)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    b = MeshSceneBuilder()
    ground = b.lambertian([0.5, 0.5, 0.5])
    b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)
    load_obj(str(obj), builder=b, scale=1.0)
    scene, tris = b.build_mesh_scene()
    assert tris.num_triangles >= 600

    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 1.5, 4.0], [0.0, 0.0, 0.0])
    cc.vfov_deg = 45.0
    cc.defocus_angle_deg = 0.0
    cfg = CFG.replace(width=48, height=32, samples_per_pixel=2,
                      samples_per_frame=2)
    mk = render(scene, cc, cfg.replace(engine="megakernel"), triangles=tris)
    fz = render(scene, cc,
                cfg.replace(engine="wavefront", intersector="bvh"),
                triangles=tris)
    assert np.isfinite(fz.accumulated).all()
    assert mk.image.std() > 0.01  # the knot is actually in frame
    assert rmse(fz.image, mk.image) < 5e-3
