"""Top-level progressive renderer.

Replaces the reference's render orchestrator
(``gpu_wavefront_pt/src/path_tracer.rs``): owns the prepared device
scene, runs sample batches (SPF) until the SPP budget is reached,
accumulates progressively, and restarts accumulation when the camera or
viewport changes (the dirty-flag semantics of
``wavefront_common/src/parameters.rs`` / ``path_tracer.rs:240-277``).

Unlike the reference there is no display surface; results are returned
as arrays and can be written to PNG / checkpointed (utils/image.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from wavefront_path_tracer_tpu.models import get_engine
from wavefront_path_tracer_tpu.scene.camera import CameraController
from wavefront_path_tracer_tpu.scene.scene import Scene
from wavefront_path_tracer_tpu.utils import compile_cache
from wavefront_path_tracer_tpu.utils.config import RenderConfig, RenderProgress


def prepare_scene(scene: Scene, config: RenderConfig, triangles=None) -> dict:
    """Host scene -> device SoA arrays (+ flattened BVH when enabled,
    + triangle tables when a mesh is present).

    The BVH build reorders spheres in place, exactly like the reference's
    ``build_bvh_tree(&mut spheres)`` (path_tracer.rs:117-118).
    """
    # Every render path (Renderer, bench.py, validate.py, chip_smoke.py)
    # stages its scene through here, and by now the platform choice is
    # final — attach the persistent compile cache so non-Renderer
    # drivers also get warm compiles (see utils/compile_cache.py).
    compile_cache.activate()
    if config.intersector == "bvh":
        from wavefront_path_tracer_tpu.ops.bvh_traverse import STACK_DEPTH
        from wavefront_path_tracer_tpu.scene.bvh import build_bvh, bvh_depth

        bvh, scene = build_bvh(scene)
        depth = bvh_depth(bvh)
        if depth > STACK_DEPTH:
            raise ValueError(
                f"BVH depth {depth} exceeds the traversal stack "
                f"({STACK_DEPTH}); pushes would be silently dropped. "
                "Raise ops.bvh_traverse.STACK_DEPTH or rebalance the scene."
            )
        extra = {
            "bvh_min": jnp.asarray(bvh.aabb_min),
            "bvh_max": jnp.asarray(bvh.aabb_max),
            "bvh_left_first": jnp.asarray(bvh.left_first),
            "bvh_prim_count": jnp.asarray(bvh.prim_count),
        }
    else:
        extra = {}
    if triangles is not None and triangles.num_triangles > 0:
        from wavefront_path_tracer_tpu.ops.triangle import triangle_normals

        if config.intersector == "bvh":
            # BVH over triangle AABBs (the generalized builder), with
            # the triangle tables reordered to BVH order like spheres.
            from wavefront_path_tracer_tpu.ops.bvh_traverse import (
                STACK_DEPTH, _flat_depth)
            from wavefront_path_tracer_tpu.scene.bvh import (
                build_flat_bvh_aabb)

            verts = np.stack([
                np.asarray(triangles.v0),
                np.asarray(triangles.v0) + np.asarray(triangles.e1),
                np.asarray(triangles.v0) + np.asarray(triangles.e2),
            ], axis=1)
            tbvh, tperm = build_flat_bvh_aabb(
                verts.min(axis=1), verts.max(axis=1))
            tdepth = _flat_depth(tbvh.left_first, tbvh.prim_count)
            if tdepth > STACK_DEPTH:
                raise ValueError(
                    f"triangle BVH depth {tdepth} exceeds the traversal "
                    f"stack ({STACK_DEPTH})")
            triangles = type(triangles)(*[
                np.asarray(t)[tperm] for t in triangles])
            extra.update({
                "tri_bvh_min": jnp.asarray(tbvh.aabb_min),
                "tri_bvh_max": jnp.asarray(tbvh.aabb_max),
                "tri_bvh_left_first": jnp.asarray(tbvh.left_first),
                "tri_bvh_prim_count": jnp.asarray(tbvh.prim_count),
            })

        e1 = jnp.asarray(triangles.e1)
        e2 = jnp.asarray(triangles.e2)
        extra.update({
            "tri_v0": jnp.asarray(triangles.v0),
            "tri_e1": e1,
            "tri_e2": e2,
            "tri_normal": triangle_normals(e1, e2),
            "tri_albedo": jnp.asarray(triangles.albedo),
            "tri_fuzz": jnp.asarray(triangles.fuzz),
            "tri_refract": jnp.asarray(triangles.refract_idx),
            "tri_mat_type": jnp.asarray(triangles.mat_type),
        })
    if scene.tex_kind is not None:
        extra.update({
            "tex_kind": jnp.asarray(scene.tex_kind),
            "tex_albedo2": jnp.asarray(scene.tex_albedo2),
            "tex_scale": jnp.asarray(scene.tex_scale),
            "tex_id": jnp.asarray(scene.tex_id),
        })
        if scene.tex_data is not None:
            extra["tex_data"] = jnp.asarray(scene.tex_data)
    arrays = {
        "centers": jnp.asarray(scene.centers),
        "radii": jnp.asarray(scene.radii),
        "mat_type": jnp.asarray(scene.mat_type),
        "albedo": jnp.asarray(scene.albedo),
        "fuzz": jnp.asarray(scene.fuzz),
        "refract_idx": jnp.asarray(scene.refract_idx),
        **extra,
    }
    return arrays


@dataclasses.dataclass
class RenderResult:
    # (H, W, 3) radiance sum over samples.  May be a device array:
    # accumulation stays on device and only crosses to the host when
    # accessed (numpy coerces via __array__), so a progressive loop that
    # never looks at the image pays no per-frame transfer.
    accumulated_dev: object
    samples: int
    wall_time_s: float
    mrays_per_s: float       # rays processed by extend+shade / wall time
    rays_traced: float = 0.0
    _accum_np: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    @property
    def accumulated(self) -> np.ndarray:
        if self._accum_np is None:
            self._accum_np = np.asarray(self.accumulated_dev)
        return self._accum_np

    @property
    def image(self) -> np.ndarray:
        """Display transform: average + gamma 2.0
        (reference display_shader.wgsl:50-53)."""
        avg = self.accumulated / max(1, self.samples)
        return np.sqrt(np.clip(avg, 0.0, None))


class Renderer:
    """Progressive renderer with accumulation-restart semantics."""

    def __init__(self, scene: Scene, camera: CameraController,
                 config: RenderConfig, triangles=None, stage_timer=None):
        # The platform choice is final by the time a Renderer exists,
        # so this is the earliest safe point to attach the persistent
        # compile cache (see utils/compile_cache.py).
        compile_cache.activate()
        self.config = config
        self.camera = camera
        # Optional utils.profiling.KernelTimer: per-kernel wall times on
        # the wavefront engine (host-stepped diagnostic loop).
        self.stage_timer = stage_timer
        self.scene_arrays = prepare_scene(scene, config, triangles)
        self.progress = RenderProgress()
        # Convergence-stop state (config.stop_delta > 0): previous
        # display image and the last measured frame-to-frame delta.
        self._prev_display = None
        self.last_delta = None
        self._converged = False
        # Device-resident accumulator: never round-trips to the host
        # between frames (unlike the reference's display path, the host
        # only sees it on export).
        self._accum = jnp.zeros((config.num_pixels, 3), jnp.float32)
        self._engine = get_engine(config.engine)

    # -- dirty-flag API (reference parameters.rs:7-59) --
    def camera_changed(self) -> None:
        self.reset_accumulation()

    def resize(self, width: int, height: int) -> None:
        self.config = self.config.replace(width=width, height=height)
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.progress.reset()
        self._accum = jnp.zeros((self.config.num_pixels, 3), jnp.float32)
        self._prev_display = None
        self.last_delta = None
        self._converged = False

    def render_frame(self) -> Optional[RenderResult]:
        """Run one SPF batch (one 'frame'); returns the running result,
        or None when the SPP budget is already met."""
        cfg = self.config
        remaining = cfg.samples_per_pixel - self.progress.accumulated_samples
        if remaining <= 0 or self._converged:
            return None
        n_samples = min(cfg.samples_per_frame, remaining)
        view = jnp.asarray(self.camera.view_matrix())
        inv_proj = jnp.asarray(self.camera.inverse_projection(cfg.width, cfg.height))
        cam = self.camera.gpu_camera()

        t0 = time.perf_counter()
        # The RNG frame salt stays fixed for a whole accumulation run;
        # progressive SPF batches are distinguished by sample_base, so
        # progressive and batched renders accumulate identical samples.
        if self.stage_timer is not None and cfg.engine == "wavefront":
            from wavefront_path_tracer_tpu.models.wavefront import (
                render_samples_staged,
            )

            rad, rays = render_samples_staged(
                self.scene_arrays, cam, view, inv_proj, cfg,
                jnp.uint32(cfg.frame),
                jnp.uint32(self.progress.accumulated_samples),
                n_samples, timer=self.stage_timer,
            )
        else:
            rad, rays = self._engine.render_samples(
                self.scene_arrays, cam, view, inv_proj, cfg,
                jnp.uint32(cfg.frame),
                jnp.uint32(self.progress.accumulated_samples),
                n_samples,
            )
        # Fetching the scalar ray count waits for the jitted step, which
        # produces the radiance in the same executable; the radiance
        # stays on the device.
        rays = float(rays)
        dt = time.perf_counter() - t0

        self._accum = self._accum + rad
        self.progress.accumulated_samples += n_samples
        self.progress.frame += 1
        result = RenderResult(
            accumulated_dev=self._accum.reshape(cfg.height, cfg.width, 3),
            samples=self.progress.accumulated_samples,
            wall_time_s=dt,
            mrays_per_s=rays / dt / 1e6,
            rays_traced=rays,
        )
        if cfg.stop_delta > 0.0:
            # Adaptive stop: mean absolute display-image change per
            # frame batch.  The display image is what the user sees, so
            # "it stopped visibly changing" is the stopping criterion;
            # the SPP budget stays the hard cap (beyond reference).
            # Computed on device — only the scalar delta crosses to the
            # host (the accumulator itself stays resident).
            img = jnp.sqrt(jnp.clip(
                self._accum / max(1, self.progress.accumulated_samples),
                0.0, None))
            if self._prev_display is not None:
                self.last_delta = float(
                    jnp.mean(jnp.abs(img - self._prev_display)))
                if self.last_delta < cfg.stop_delta:
                    self._converged = True
            self._prev_display = img
        return result

    def render(self) -> RenderResult:
        """Render the full SPP budget; returns the final result."""
        result = None
        while True:
            r = self.render_frame()
            if r is None:
                break
            result = r
        assert result is not None
        return result


def render(scene: Scene, camera: CameraController, config: RenderConfig,
           triangles=None) -> RenderResult:
    """One-shot convenience wrapper."""
    return Renderer(scene, camera, config, triangles).render()
