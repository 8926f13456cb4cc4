"""AOV (arbitrary output variable) passes: albedo / normal / depth.

Production path tracers emit first-hit feature planes alongside the
beauty pass — they feed denoisers, compositing, and debugging.  The
reference renders radiance only (its display pass is the whole output
surface, display.rs:112-150); this is a beyond-parity capability.

AOVs reuse the XLA ops the engines share (raygen + nearest-hit
resolve), averaged over ``spp`` anti-aliased primary samples with the
same per-(pixel, sample) RNG streams as the engines, so AOV edges are
filtered exactly like the beauty pass:

* ``albedo``  — first-hit material albedo (miss lanes contribute the
  sky color, matching what a denoiser wants to divide out),
* ``normal``  — first-hit geometric normal (zero on miss; averaged
  then re-normalized),
* ``depth``   — first-hit ray distance t (miss lanes contribute 0 and
  are excluded from the average; ``coverage`` holds the hit fraction).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from wavefront_path_tracer_tpu.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu.ops.intersect import sky_color
from wavefront_path_tracer_tpu.ops.raygen import generate_rays
from wavefront_path_tracer_tpu.renderer import prepare_scene
from wavefront_path_tracer_tpu.utils.config import RenderConfig


def render_aovs(scene, camera, config: RenderConfig, triangles=None,
                spp: int | None = None, frame: int = 0,
                scene_arrays: dict | None = None) -> dict:
    """First-hit AOV planes as (H, W, C) numpy arrays.

    Returns ``{"albedo": (H,W,3), "normal": (H,W,3), "depth": (H,W),
    "coverage": (H,W)}``.  ``spp`` defaults to
    ``config.samples_per_pixel`` (AA averaging only — AOVs are
    first-hit quantities, so a handful of samples suffices).  Pass
    ``scene_arrays`` (an existing ``prepare_scene`` result) to skip a
    second device upload.  Pixels go through the engines' ray-chunk
    loop so intersect intermediates stay bounded at any resolution.
    """
    cfg = config
    spp = int(spp if spp is not None else cfg.samples_per_pixel)
    arrays = (scene_arrays if scene_arrays is not None
              else prepare_scene(scene, cfg, triangles=triangles))
    view = jnp.asarray(camera.view_matrix())
    inv_proj = jnp.asarray(camera.inverse_projection(cfg.width, cfg.height))
    cam = camera.gpu_camera()
    num = cfg.num_pixels
    # config.ray_chunk 0 means "one chunk"; AOVs cap it anyway so the
    # intersect intermediates stay bounded at production resolutions.
    chunk = cfg.ray_chunk if cfg.ray_chunk > 0 else 131072
    chunk = min(num, chunk)

    @jax.jit
    def one(pixel_idx, sample, acc):
        alb_a, nrm_a, dep_a, cov_a = acc
        origin, direction = generate_rays(
            pixel_idx, cfg.width, cfg.height, jnp.uint32(frame), sample,
            cam, view, inv_proj, sampler=cfg.sampler)
        t, hit, normal, albedo, _fz, _ri, _mt = intersect_and_resolve(
            origin, direction, arrays, cfg)
        # Chunk-padding lanes (pixel_idx >= num) count as misses; their
        # rows are dropped on the host below.
        hit = hit & (pixel_idx < jnp.uint32(num))
        h = hit[:, None]
        alb = jnp.where(h, albedo, sky_color(direction))
        nrm = jnp.where(h, normal, 0.0)
        dep = jnp.where(hit, t, 0.0)
        return (alb_a + alb, nrm_a + nrm, dep_a + dep,
                cov_a + hit.astype(jnp.float32))

    parts = []
    for start in range(0, num, chunk):
        idx = start + np.arange(chunk, dtype=np.uint32)
        valid = idx < num
        # Padding lanes get the sentinel index `num` (counted as
        # misses in the kernel) and are dropped below.
        pixel_idx = jnp.asarray(np.where(valid, idx,
                                         num).astype(np.uint32))
        acc = (jnp.zeros((chunk, 3)), jnp.zeros((chunk, 3)),
               jnp.zeros((chunk,)), jnp.zeros((chunk,)))
        for s in range(spp):
            acc = one(pixel_idx, jnp.uint32(s), acc)
        parts.append([np.array(a)[valid] for a in acc])
    alb, nrm, dep, cov = (np.concatenate([p[i] for p in parts])
                          for i in range(4))

    alb /= spp
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(nlen, 1e-12)
    dep = dep / np.maximum(cov, 1e-12)       # mean over HIT samples
    cov /= spp

    shp = (cfg.height, cfg.width)
    return {
        "albedo": alb.reshape(shp + (3,)),
        "normal": nrm.reshape(shp + (3,)),
        "depth": dep.reshape(shp),
        "coverage": cov.reshape(shp),
    }


def write_aovs(prefix: str, aovs: dict) -> list:
    """Write AOVs: raw ``{prefix}.aov.npz`` plus viewable PNGs
    (normals remapped to [0,1]; depth as 1/(1+t) — white near, dark
    far, black sky).  Returns the paths written."""
    from wavefront_path_tracer_tpu.utils.image import write_png

    paths = [f"{prefix}.aov.npz"]
    np.savez_compressed(paths[0], **aovs)
    ims = {
        "albedo": aovs["albedo"],
        "normal": aovs["normal"] * 0.5 + 0.5,
        "depth": np.where(aovs["coverage"][..., None] > 0.0,
                          1.0 / (1.0 + aovs["depth"][..., None]),
                          0.0) * np.ones(3),
    }
    for name, im in ims.items():
        p = f"{prefix}.{name}.png"
        write_png(p, np.clip(im, 0.0, 1.0))
        paths.append(p)
    return paths
