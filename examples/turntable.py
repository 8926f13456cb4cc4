"""Turntable animation: orbit the camera around a scene, write a GIF.

Demonstrates that camera parameters are *traced inputs* to every
engine — moving the camera re-renders without recompiling (the
reference's interactive-camera property, app.rs:102-121, in batch
form).  One process renders all frames, each one jitted dispatch.

Usage:
    python examples/turntable.py --scene book_cover --frames 24 \
        --width 320 --height 180 --spp 64 --out turntable.gif
"""
import argparse
import math
import os
import sys
import time

from PIL import Image  # fail before rendering, not after

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from wavefront_path_tracer_tpu.renderer import render  # noqa: E402
from wavefront_path_tracer_tpu.scene import CameraController  # noqa: E402
from wavefront_path_tracer_tpu.scene.scene import get_scene  # noqa: E402
from wavefront_path_tracer_tpu.utils.config import (  # noqa: E402
    DEFAULT_ENGINE, DEFAULT_INTERSECTOR, ENGINES, INTERSECTORS, RenderConfig)
from wavefront_path_tracer_tpu.utils.image import to_u8  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="book_cover")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--engine", default=DEFAULT_ENGINE, choices=ENGINES)
    p.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                   choices=INTERSECTORS)
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--elevation", type=float, default=1.2)
    p.add_argument("--center", type=float, nargs=3, default=[0.0, 0.0, -1.0])
    p.add_argument("--vfov", type=float, default=40.0)
    p.add_argument("--out", default="turntable.gif")
    p.add_argument("--ms-per-frame", type=int, default=80)
    args = p.parse_args()

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       samples_per_frame=args.spp, max_bounces=16,
                       engine=args.engine, intersector=args.intersector)
    scene = get_scene(args.scene)
    cx, cy, cz = args.center
    frames = []
    for k in range(args.frames):
        th = 2.0 * math.pi * k / args.frames
        cc = CameraController.book_one_final()
        cc.camera = cc.camera.look_at(
            [cx + args.radius * math.cos(th), cy + args.elevation,
             cz + args.radius * math.sin(th)], [cx, cy, cz])
        cc.vfov_deg = args.vfov
        cc.defocus_angle_deg = 0.0
        t0 = time.perf_counter()
        r = render(scene, cc, cfg)
        dt = time.perf_counter() - t0
        frames.append(to_u8(r.image))
        print(f"frame {k + 1}/{args.frames}: {dt:.2f}s "
              f"({r.mrays_per_s:.0f} Mrays/s)", flush=True)

    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(args.out, save_all=True, append_images=ims[1:],
                duration=args.ms_per_frame, loop=0)
    print(f"wrote {args.out}: {args.frames} frames "
          f"{args.width}x{args.height} @ {args.spp} spp")


if __name__ == "__main__":
    main()
