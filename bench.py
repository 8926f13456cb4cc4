"""Benchmark runner: Mrays/s on the Shirley book-1 final scene.

Prints one JSON line per measured configuration:
  {"metric": ..., "value": N, "unit": "Mrays/s", "seconds": ...,
   "platform": "gpu", "device_kind": ..., "device_count": ...,
   "name": ..., "power_limit": ...}

The metric is rays processed by extend+shade per second (live rays
summed over bounces / wall time), the BASELINE.json headline.  The
device fields come from JAX and the card fields from ``nvidia-smi``.

The runner measures a GPU.  It refuses any other platform unless the
caller passes ``--platform cpu`` explicitly (the CPU tests do: a CPU
number is a plumbing check, never a device measurement).  Any failed
configuration exits non-zero; there is no fallback record.

Flags (optional): --width --height --spp --engine --intersector
--scene --all (every engine x intersector) --mesh TILESxSAMPLES (shard
over a device mesh) --no-mesh-row --platform.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from wavefront_path_tracer_tpu.utils.config import (
    DEFAULT_ENGINE,
    DEFAULT_INTERSECTOR,
    ENGINES,
    INTERSECTORS,
)

# Mesh rows recorded beside the headline (key, scene, w, h, spp,
# intersector), on the production engine: the 5k-triangle terrain and the
# 50k-triangle torus knot (the incoherent-ray stress scene; small spp).
# Meshes take the BVH: brute force over 5k-50k triangles per ray is the
# path the BVH exists to avoid.
MESH_ROWS = [
    ("terrain", "mesh_terrain", 800, 448, 32, "bvh"),
    ("knot50k", "mesh_knot50k", 800, 448, 8, "bvh"),
]


def knot_tris(scene_name: str) -> int:
    """Triangle budget encoded in a knot scene name: 'mesh_knot' (the
    50k default) or 'mesh_knot<N>k'.  Malformed names (a bare numeric
    suffix, a missing count) are errors, not silent 50k fallbacks — a
    typo'd MESH_ROWS entry must fail, not record a mislabeled row."""
    import re

    m = re.fullmatch(r"mesh_knot(?:(\d+)k)?", scene_name)
    if m is None:
        raise ValueError(
            f"bad knot scene name {scene_name!r}: expected "
            "'mesh_knot' or 'mesh_knot<N>k' (e.g. mesh_knot50k)")
    return int(m.group(1)) * 1000 if m.group(1) else 50000


def bench_once(scene_name: str, width: int, height: int, spp: int,
               engine: str = DEFAULT_ENGINE,
               intersector: str = DEFAULT_INTERSECTOR,
               max_bounces: int = 50, rr_start: int = 0, mesh_spec=None):
    import jax
    import jax.numpy as jnp

    from wavefront_path_tracer_tpu.models import get_engine
    from wavefront_path_tracer_tpu.renderer import prepare_scene
    from wavefront_path_tracer_tpu.scene import CameraController
    from wavefront_path_tracer_tpu.scene.scene import get_scene
    from wavefront_path_tracer_tpu.utils.config import RenderConfig

    cfg = RenderConfig(
        width=width, height=height, samples_per_pixel=spp,
        samples_per_frame=spp, max_bounces=max_bounces,
        engine=engine, intersector=intersector, rr_start_bounce=rr_start,
    )
    triangles = None
    if scene_name == "mesh_demo":
        from wavefront_path_tracer_tpu.scene.mesh import mesh_demo_scene

        scene, triangles = mesh_demo_scene()
    elif scene_name == "mesh_terrain":
        from wavefront_path_tracer_tpu.scene.mesh import mesh_terrain_scene

        scene, triangles = mesh_terrain_scene()
    elif scene_name.startswith("mesh_knot"):
        # Procedural torus knot (examples/gen_obj.py), e.g.
        # "mesh_knot50k" — the incoherent-ray mesh stress scene.
        from examples.gen_obj import torus_knot
        from wavefront_path_tracer_tpu.scene.mesh import MeshSceneBuilder

        tris = knot_tris(scene_name)
        b = MeshSceneBuilder()
        b.sphere([0.0, -1000.0, 0.0], 1000.0,
                 b.lambertian([0.5, 0.5, 0.5]))
        v, f = torus_knot(tris)
        b.mesh(v, f, b.lambertian([0.7, 0.3, 0.2]))
        scene, triangles = b.build_mesh_scene()
    else:
        scene = get_scene(scene_name)
    cc = CameraController.book_one_final()
    if scene_name.startswith("mesh_knot"):
        # Frame the knot (the book camera points away from the origin).
        cc.camera = cc.camera.look_at([0.0, 1.5, 4.0], [0.0, 0.0, 0.0])
        cc.vfov_deg = 40.0
        cc.defocus_angle_deg = 0.0
    arrays = prepare_scene(scene, cfg, triangles=triangles)
    view = jnp.asarray(cc.view_matrix())
    inv_proj = jnp.asarray(cc.inverse_projection(cfg.width, cfg.height))
    cam = cc.gpu_camera()

    if mesh_spec is not None:
        # Shard the render over a tiles x samples device mesh
        # (parallel/sharding.py).
        from wavefront_path_tracer_tpu.parallel.sharding import (
            make_mesh, render_samples_sharded)

        tile_ax, sample_ax = mesh_spec
        mesh = make_mesh(tile_ax * sample_ax, sample_axis=sample_ax)

        def run(n):
            return render_samples_sharded(
                mesh, arrays, cam, view, inv_proj, cfg, jnp.uint32(0),
                jnp.uint32(0), n)

    else:
        eng = get_engine(engine)

        def run(n):
            return eng.render_samples(
                arrays, cam, view, inv_proj, cfg, jnp.uint32(0),
                jnp.uint32(0), n)

    # Warmup with the SAME static n_samples as the timed run, so the
    # timed section never includes compilation.
    t0 = time.perf_counter()
    jax.block_until_ready(run(spp))
    first_s = time.perf_counter() - t0

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(spp))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    if mesh_spec is not None:
        rays = None      # the sharded step returns radiance only
    else:
        rays = float(out[1])
    return {
        "scene": scene_name,
        "config": (f"{width}x{height}@{spp}spp/{engine}/{intersector}"
                   + (f"/mesh{mesh_spec[0]}x{mesh_spec[1]}" if mesh_spec
                      else "")),
        "rays": rays,
        "seconds": dt,
        "first_call_seconds": first_s,
        "mrays_per_s": rays / dt / 1e6 if rays is not None else None,
        "msamples_per_s": width * height * spp / dt / 1e6,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="book_one_final")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    # Default batch IS the BASELINE convergence workload (1000 spp at
    # 1080p in one dispatch); small-spp numbers are tail-bound.
    p.add_argument("--spp", type=int, default=1000)
    p.add_argument("--engine", default=DEFAULT_ENGINE, choices=ENGINES)
    p.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                   choices=INTERSECTORS)
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--rr", type=int, default=0,
                   help="Russian roulette start bounce (0 = off)")
    p.add_argument("--mesh", default=None, metavar="TILESxSAMPLES",
                   help="shard over a jax device mesh, e.g. 2x2 "
                        "(requires that many attached devices)")
    p.add_argument("--all", action="store_true",
                   help="measure every engine x intersector")
    p.add_argument("--no-mesh-row", action="store_true",
                   help="skip the mesh-scene rows")
    p.add_argument("--platform", default=None,
                   help="run on this jax platform instead of the GPU "
                        "(cpu: a plumbing check, not a measurement)")
    return p


def parse_mesh(spec):
    if spec is None:
        return None
    t, s = spec.lower().split("x")
    return int(t), int(s)


def _line(result: dict, device: dict) -> str:
    # A sharded step returns radiance only, so a --mesh row reports
    # pixel-samples per second instead of rays.
    rays = result["mrays_per_s"] is not None
    metric = "Mrays/s extend+shade" if rays else "Msamples/s"
    out = {
        "metric": f"{metric} ({result['config']}, {result['scene']})",
        "value": result["mrays_per_s" if rays else "msamples_per_s"],
        "unit": "Mrays/s" if rays else "Msamples/s",
        "seconds": result["seconds"],
        "first_call_seconds": result["first_call_seconds"],
        **{k: device[k] for k in ("platform", "device_kind",
                                  "device_count", "name", "power_limit")},
    }
    if device["platform"] != "gpu":
        out["note"] = "plumbing check off the GPU, not a device measurement"
    return json.dumps(out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from wavefront_path_tracer_tpu.utils.device import device_info

    device = device_info()
    if device["platform"] != "gpu" and args.platform != device["platform"]:
        print(f"bench.py: found platform {device['platform']!r}, not a GPU; "
              "refusing to report (pass --platform cpu for a plumbing "
              "check)", file=sys.stderr)
        return 2
    print(f"device: {device}", file=sys.stderr)

    mesh_spec = parse_mesh(args.mesh)
    if args.all:
        configs = [(e, i) for e in ENGINES for i in INTERSECTORS]
    else:
        configs = [(args.engine, args.intersector)]
    for engine, intersector in configs:
        r = bench_once(args.scene, args.width, args.height, args.spp,
                       engine, intersector, args.max_bounces,
                       rr_start=args.rr, mesh_spec=mesh_spec)
        print(_line(r, device), flush=True)
    if not args.no_mesh_row and not args.all and not mesh_spec:
        for key, m_scene, mw, mh, mspp, m_isect in MESH_ROWS:
            r = bench_once(m_scene, mw, mh, mspp, args.engine, m_isect,
                           args.max_bounces)
            print(_line(r, device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
