"""Command-line renderer — the app layer.

Replaces the reference's binary entry point + event loop
(``gpu_wavefront_pt/src/main.rs``, ``app.rs``): scene/camera selection,
render-parameter plumbing, the progressive frame loop with FPS/timing
reports, and output.  Headless: writes PNG (and optional checkpoints)
instead of presenting to a surface; every hardcoded constant of the
reference (viewport ``main.rs:33``, SPP/SPF ``parameters.rs:4-5``,
bounce cap ``path_tracer.rs:323``) is a flag here.

Example::

    python -m wavefront_path_tracer_tpu.cli \
        --scene book_one_final --width 640 --height 360 --spp 64 \
        --out render.png
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from wavefront_path_tracer_tpu.utils.config import (
    DEFAULT_ENGINE,
    DEFAULT_INTERSECTOR,
    ENGINES,
    INTERSECTORS,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wavefront_path_tracer_tpu",
        description="Wavefront path tracer in JAX",
    )
    p.add_argument("--scene", default="book_one_final",
                   help="book_cover | book_one_final | procedural | "
                        "cornell_spheres | mesh_demo | mesh_terrain")
    p.add_argument("--scene-file", default=None, metavar="JSON",
                   help="render a user scene file (spheres + materials "
                        "+ optional camera; see scene/file.py) instead "
                        "of a named --scene; the file's camera block, "
                        "if present, wins over the CLI camera flags")
    p.add_argument("--scene-seed", type=int, default=42)
    p.add_argument("--spheres", type=int, default=10000,
                   help="sphere count for --scene procedural")
    p.add_argument("--obj", default=None,
                   help="render an OBJ file (triangle mesh; all engines)")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=225)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--spf", type=int, default=1, help="samples per frame batch")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--engine", default=DEFAULT_ENGINE, choices=ENGINES)
    p.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                   choices=INTERSECTORS + ("auto",),
                   help="auto = the production default "
                        f"({DEFAULT_INTERSECTOR}, fastest on an H100; "
                        "PERF.md)")
    p.add_argument("--frame", type=int, default=0, help="RNG frame salt")
    p.add_argument("--sampler", default="random",
                   choices=("random", "stratified"),
                   help="AA sampler: 'random' (reference semantics) or "
                        "'stratified' (4x4 stratum AA jitter, unbiased, "
                        "lower variance at low spp; all engines)")
    p.add_argument("--rr", type=int, default=0, metavar="BOUNCE",
                   help="Russian roulette from the given surface event "
                        "on (0 = off, the reference's trace-to-cap "
                        "semantics; unbiased, faster convergence on "
                        "bounce-heavy scenes)")
    p.add_argument("--rr-floor", type=float, default=0.05, metavar="P",
                   help="roulette survival floor: continue probability "
                        "is clip(max(throughput), P, 1); higher = fewer "
                        "fireflies, more rays (default 0.05)")
    # Camera.  Unset flags fall back per-field to: scene-file camera
    # block -> the named scene's default view (scene.SCENE_CAMERAS) ->
    # the reference camera (main.rs:23-32).
    p.add_argument("--look-from", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--vfov", type=float, default=None)
    p.add_argument("--defocus-angle", type=float, default=None)
    p.add_argument("--focus-distance", default=None,
                   help="thin-lens focus distance, or 'auto' to focus "
                        "at the effective look-at point (default 10, "
                        "the reference's; same fallback chain as the "
                        "other camera flags)")
    p.add_argument("--tonemap", default="gamma2",
                   choices=("gamma2", "reinhard", "aces"),
                   help="display transform: gamma2 (reference "
                        "display_shader.wgsl semantics), or "
                        "reinhard/aces HDR tone maps (+gamma2 encode)")
    p.add_argument("--out", default="render.png")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="per-sample radiance clamp (0 = off).  In the "
                        "RTIOW model per-sample radiance is <= 1 by "
                        "construction (albedo <= 1, sky <= 1, roulette "
                        "weights bounded), so >= 1 is provably a no-op "
                        "(measured: exp/clamp_bias.py); < 1 trades "
                        "darkening bias for variance")
    p.add_argument("--until-delta", type=float, default=0.0,
                   metavar="D",
                   help="stop early once the display image changes by "
                        "less than D (mean abs per channel) between "
                        "frame batches; --spp stays the hard cap")
    p.add_argument("--aov", default=None, metavar="PREFIX",
                   help="also write first-hit AOV passes (albedo / "
                        "normal / depth + raw npz) as PREFIX.*.png")
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="rewrite this PNG after every frame batch and "
                        "emit an auto-refresh HTML viewer next to it "
                        "(the reference's per-frame display pass, "
                        "display.rs:112-150, headless)")
    p.add_argument("--preview-term", action="store_true",
                   help="draw the converging image in the terminal "
                        "(24-bit ANSI half-blocks) after every frame")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live render window over HTTP: frames "
                        "are pushed to the browser as they converge "
                        "(multipart stream — the headless analog of "
                        "the reference's swapchain present, "
                        "display.rs:112-150); 0 picks a free port; with "
                        "--interactive the page's keyboard steers the "
                        "camera (wasd/qe/ikjl/[], x quits)")
    p.add_argument("--serve-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --serve (default loopback; "
                        "the endpoints carry no auth, so binding "
                        "0.0.0.0 to view remotely is an explicit "
                        "opt-in)")
    p.add_argument("--interactive", action="store_true",
                   help="live watch-and-steer session (the reference's "
                        "app.rs:102-121 loop, headless): renders "
                        "continuously, WASD/QE move and i/k/j/l look "
                        "between frame batches with accumulation "
                        "restart; combine with --preview and/or "
                        "--preview-term to watch")
    p.add_argument("--checkpoint", default=None,
                   help="npz accumulation checkpoint to write each frame")
    p.add_argument("--resume", default=None,
                   help="npz checkpoint to resume accumulation from")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu)")
    p.add_argument("--stage-timing", action="store_true",
                   help="per-kernel observability like the reference's "
                        "per-sample us report (path_tracer.rs:364): real "
                        "generate/extend/shade/miss/compact wall-us on the "
                        "wavefront engine (host-stepped)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the first frame "
                        "into this directory (the deep-dive analog of the "
                        "reference's per-kernel GPU timestamps)")
    return p


def resolve_intersector(intersector):
    """Resolve 'auto' to the production default; (intersector, notes).
    Shared by the CLI and the interactive REPL."""
    notes = []
    if intersector == "auto":
        intersector = DEFAULT_INTERSECTOR
        notes.append(f"note: --intersector auto -> {intersector}")
    return intersector, notes


def build_scene(args):
    """(scene, triangles | None, file_camera | None) from parsed CLI
    args — shared with the interactive REPL (app.py) so every
    documented --scene value works in both entry points."""
    from wavefront_path_tracer_tpu.scene.scene import get_scene

    if getattr(args, "scene_file", None):
        from wavefront_path_tracer_tpu.scene.file import load_scene_file

        return load_scene_file(args.scene_file)
    if args.obj:
        from wavefront_path_tracer_tpu.scene.mesh import MeshSceneBuilder, load_obj

        b = MeshSceneBuilder()
        ground = b.lambertian([0.5, 0.5, 0.5])
        b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)
        load_obj(args.obj, builder=b, scale=args.obj_scale)
        return b.build_mesh_scene() + (None,)
    if args.scene == "mesh_demo":
        from wavefront_path_tracer_tpu.scene.mesh import mesh_demo_scene

        return mesh_demo_scene() + (None,)
    if args.scene == "mesh_terrain":
        from wavefront_path_tracer_tpu.scene.mesh import mesh_terrain_scene

        return mesh_terrain_scene(seed=args.scene_seed) + (None,)
    scene_kwargs = {}
    if args.scene == "book_one_final":
        scene_kwargs["seed"] = args.scene_seed
    elif args.scene == "procedural":
        scene_kwargs = {"n": args.spheres, "seed": args.scene_seed}
    return get_scene(args.scene, **scene_kwargs), None, None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    # Always say where the render runs, so a silent CPU run is visible.
    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", file=sys.stderr)

    from wavefront_path_tracer_tpu.renderer import Renderer
    from wavefront_path_tracer_tpu.scene import CameraController
    from wavefront_path_tracer_tpu.scene.scene import get_scene
    from wavefront_path_tracer_tpu.utils.config import RenderConfig
    from wavefront_path_tracer_tpu.utils.image import (
        load_checkpoint,
        save_checkpoint,
        write_png,
    )
    from wavefront_path_tracer_tpu.utils.profiling import FramesPerSecond

    scene, triangles, file_cam = build_scene(args)

    intersector, notes = resolve_intersector(args.intersector)
    if not args.quiet:
        for n in notes:
            print(n, file=sys.stderr)

    # Per-field camera resolution: explicit CLI flag > scene-file
    # camera block > the named scene's default view > the reference
    # camera.  Resolved BEFORE autofocus so 'auto' focuses at the
    # effective look point.
    from wavefront_path_tracer_tpu.scene.scene import SCENE_CAMERAS

    scene_cam = {} if args.scene_file else SCENE_CAMERAS.get(args.scene, {})
    file_cam = file_cam or {}
    ref_cam = {"look_from": [13.0, 2.0, 3.0], "look_at": [0.0, 0.0, 0.0],
               "vfov": 20.0, "defocus_angle": 0.6}

    def cam_field(name, cli_value):
        if cli_value is not None:
            return cli_value
        for layer in (file_cam, scene_cam, ref_cam):
            if name in layer:
                return layer[name]
        return None

    look_from = cam_field("look_from", args.look_from)
    look_at = cam_field("look_at", args.look_at)
    if args.focus_distance is not None:
        focus = args.focus_distance
    else:
        focus = file_cam.get("focus_distance",
                             scene_cam.get("focus_distance", 10.0))
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at(look_from, look_at)
    cc.vfov_deg = float(cam_field("vfov", args.vfov))
    cc.defocus_angle_deg = float(cam_field("defocus_angle",
                                           args.defocus_angle))
    if str(focus).lower() == "auto":
        cc.focus_distance = float(np.linalg.norm(
            np.asarray(look_at, np.float64)
            - np.asarray(look_from, np.float64)))
    else:
        cc.focus_distance = float(focus)

    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, samples_per_frame=args.spf,
        max_bounces=args.max_bounces, frame=args.frame,
        engine=args.engine, intersector=intersector,
        sampler=args.sampler,
        rr_start_bounce=args.rr, rr_floor=args.rr_floor,
        clamp=args.clamp, stop_delta=args.until_delta,
    )

    server = None
    if args.serve is not None:
        from wavefront_path_tracer_tpu.utils.preview_server import (
            PreviewServer)

        server = PreviewServer(port=args.serve, host=args.serve_host)
        if not args.quiet:
            print(f"live render window: http://localhost:{server.port}/",
                  file=sys.stderr)

    if args.interactive:
        from wavefront_path_tracer_tpu.app import (
            InteractiveSession, interactive_loop)

        if args.preview:
            from wavefront_path_tracer_tpu.utils.preview import (
                write_preview_html)

            html = write_preview_html(args.preview)
            if not args.quiet:
                print(f"live preview: open {html}", file=sys.stderr)
        session = InteractiveSession(scene, cc, cfg, triangles=triangles)
        interactive_loop(session, out_png=args.preview or args.out,
                         show_term=args.preview_term or None,
                         publish=server.publish if server else None,
                         key_source=server.pop_keys if server else None,
                         tonemap=args.tonemap)
        samples = session.renderer.progress.accumulated_samples
        if samples:
            from wavefront_path_tracer_tpu.utils.image import (
                display_transform)

            final = display_transform(
                session.renderer._accum.reshape(cfg.height, cfg.width, 3),
                samples, args.tonemap)
            write_png(args.out, final)
            if server:
                server.publish(final, samples=samples, done=True)
            if not args.quiet:
                print(f"wrote {args.out} @ {samples} spp", file=sys.stderr)
        return 0

    stage_timer = None
    if args.stage_timing:
        from wavefront_path_tracer_tpu.utils.profiling import KernelTimer

        stage_timer = KernelTimer()
        if args.engine == "megakernel":
            print("note: --stage-timing reports on the wavefront "
                  "engine only", file=sys.stderr)
            stage_timer = None

    renderer = Renderer(scene, cc, cfg, triangles=triangles,
                        stage_timer=stage_timer)
    import os

    ckpt_meta = {
        "width": cfg.width, "height": cfg.height,
        # A scene file identifies by absolute path so --resume cannot
        # silently blend checkpoints from a different user scene.
        "scene": (f"file:{os.path.abspath(args.scene_file)}"
                  if args.scene_file else args.scene),
        "engine": cfg.engine, "frame": cfg.frame,
    }
    if args.resume:
        acc, samples, frame = load_checkpoint(args.resume, expect_meta=ckpt_meta)
        renderer._accum = acc.reshape(-1, 3).astype(np.float32)
        renderer.progress.accumulated_samples = samples
        renderer.progress.frame = frame
        if not args.quiet:
            print(f"resumed at {samples} spp", file=sys.stderr)

    if args.preview:
        from wavefront_path_tracer_tpu.utils.preview import write_preview_html

        html = write_preview_html(args.preview)
        if not args.quiet:
            print(f"live preview: open {html}", file=sys.stderr)

    from wavefront_path_tracer_tpu.utils.profiling import RenderStats

    fps = FramesPerSecond()
    stats = RenderStats(pixels=cfg.num_pixels)
    t_start = time.perf_counter()
    result = None
    first = None     # the first frame's (seconds, rays): it pays the compile
    first_frame = True
    while True:
        if first_frame and args.profile_dir:
            from wavefront_path_tracer_tpu.utils.profiling import trace_to

            with trace_to(args.profile_dir):
                r = renderer.render_frame()
        else:
            r = renderer.render_frame()
        first_frame = False
        if r is None:
            break
        result = r
        if first is None:
            first = (r.wall_time_s, r.rays_traced)
        fps.update()
        stats.rays_traced += r.rays_traced
        stats.seconds += r.wall_time_s
        stats.samples = r.samples
        if args.preview:
            from wavefront_path_tracer_tpu.utils.image import (
                display_transform as _dt)

            write_png(args.preview, _dt(r.accumulated, r.samples,
                                        args.tonemap))
        if server is not None:
            from wavefront_path_tracer_tpu.utils.image import (
                display_transform as _dts)

            server.publish(_dts(r.accumulated, r.samples, args.tonemap),
                           samples=r.samples,
                           target_spp=cfg.samples_per_pixel,
                           mrays_per_s=r.mrays_per_s,
                           fps=fps.get_avg_fps(),
                           frame=renderer.progress.frame, done=False)
        if args.preview_term:
            from wavefront_path_tracer_tpu.utils.preview import term_preview_frame

            from wavefront_path_tracer_tpu.utils.image import (
                display_transform as _dt2)

            pct = 100.0 * renderer.progress.progress(cfg.samples_per_pixel)
            term_preview_frame(
                _dt2(r.accumulated, r.samples, args.tonemap),
                f"[{pct:5.1f}%] {r.samples}/{cfg.samples_per_pixel} spp  "
                f"{r.mrays_per_s:.1f} Mrays/s")
        if args.checkpoint:
            save_checkpoint(args.checkpoint, renderer._accum,
                            renderer.progress.accumulated_samples,
                            renderer.progress.frame, meta=ckpt_meta)
        if not args.quiet:
            pct = 100.0 * renderer.progress.progress(cfg.samples_per_pixel)
            print(
                f"[{pct:5.1f}%] {r.samples}/{cfg.samples_per_pixel} spp  "
                f"{r.mrays_per_s:8.1f} Mrays/s  {fps.get_avg_fps():5.1f} fps",
                file=sys.stderr,
            )
            if stage_timer is not None and stage_timer.averages_us():
                print(f"         kernels: {stage_timer.report()}",
                      file=sys.stderr)

    if result is None:
        print("nothing to render (SPP budget already met)", file=sys.stderr)
        return 1
    from wavefront_path_tracer_tpu.utils.image import display_transform

    write_png(args.out, display_transform(result.accumulated,
                                          result.samples, args.tonemap))
    if server is not None:
        # Final present: push the finished frame and flag completion so
        # open viewer tabs show "done" before the process exits.
        server.publish(display_transform(result.accumulated, result.samples,
                                         args.tonemap),
                       samples=result.samples,
                       target_spp=cfg.samples_per_pixel,
                       mrays_per_s=result.mrays_per_s,
                       fps=fps.get_avg_fps(),
                       frame=renderer.progress.frame, done=True)
    if args.aov:
        from wavefront_path_tracer_tpu.aov import render_aovs, write_aovs

        paths = write_aovs(args.aov, render_aovs(
            scene, cc, cfg, triangles=triangles,
            spp=min(cfg.samples_per_pixel, 16), frame=cfg.frame,
            scene_arrays=renderer.scene_arrays))
        if not args.quiet:
            print(f"wrote AOVs: {', '.join(paths)}", file=sys.stderr)
    if not args.quiet:
        total = time.perf_counter() - t_start
        print(
            f"wrote {args.out}: {cfg.width}x{cfg.height} @ {result.samples} spp "
            f"in {total:.1f}s  [{stats.report()}]", file=sys.stderr,
        )
        # Frames after the first run compiled code: their rate is the
        # steady-state throughput, and the first frame's excess over a
        # steady frame is the compile.
        later_s = stats.seconds - first[0]
        if later_s > 0:
            print(f"first frame {first[0]:.3f}s (includes compile); "
                  f"later frames {(stats.rays_traced - first[1]) / later_s / 1e6:.1f}"
                  f" Mrays/s in {later_s:.3f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
