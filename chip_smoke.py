"""Chip smoke test: the renderer's main path on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py              # one card, phases 1-4 below
    python chip_smoke.py --multi-gpu  # four cards: sharded renders only

One process holds the card(s) and calls the entry points in-process; it
never starts a second JAX process.  Phases (one card):

1. Device: requires ``jax.devices()[0].platform == "gpu"`` and prints
   the ``nvidia-smi`` name and power limit.
2. Main path: ``cli.main`` renders book_one_final at 1920x1080, 32 spp
   in frames of 8, 50 bounces, with the default engine; the radiance
   must be finite with a plausible mean.  Prints Mrays/s, wall time
   and the compile estimate.
3. Correctness: ``validate.main`` gates every engine x intersector at
   400x225 @ 1000 spp against the committed CPU golden (display-image
   RMSE < 1e-3), and the max abs difference between the two engines
   is printed at one config.
4. Mesh: ``cli.main`` renders mesh_terrain with the BVH at 800x448 @ 8
   spp; the radiance must be finite.

``--multi-gpu`` runs only ``render_samples_sharded`` on a 4x1 (tiles)
and a 2x2 (tiles x samples) mesh at 1920x1080 @ 16 spp with the default
engine, each compared in the same process with a one-card render of the
same config.  It prints the max abs difference of the radiance sums
and gates the display images at RMSE < 1e-3: XLA compiles the
per-device module with its own fusions, so float rounding can differ
in the last bit and send a few paths another way (PERF.md).

The last line of stdout is ``{"ok": true, "device": {...}}``.  Any
failed phase raises before it, so the exit code is non-zero and no
``ok`` line is printed; so does a machine without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "golden", "oracle_book_400x225_1000spp.npz")
GATE = 1e-3          # the BASELINE display-image RMSE gate


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


class _Tee(io.TextIOBase):
    """Copy writes to a stream and keep them for parsing."""

    def __init__(self, stream):
        self.stream, self.buf = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def _run_cli(argv):
    """``cli.main(argv)`` with its stderr shown and captured."""
    from wavefront_path_tracer_tpu import cli

    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    return tee.buf.getvalue(), wall


def _radiance(checkpoint: str, width: int, height: int, spp: int):
    import numpy as np

    from wavefront_path_tracer_tpu.utils.image import load_checkpoint

    acc, samples, _ = load_checkpoint(checkpoint)
    check(samples == spp, f"{checkpoint}: {samples} spp, expected {spp}")
    check(acc.shape == (width * height, 3),
          f"{checkpoint}: radiance shape {acc.shape}")
    check(bool(np.isfinite(acc).all()), f"{checkpoint}: non-finite radiance")
    return acc


def phase_main_path(tmp: str) -> None:
    import numpy as np

    w, h, spp, spf = 1920, 1080, 32, 8
    ck = os.path.join(tmp, "book.npz")
    err, wall = _run_cli([
        "--scene", "book_one_final", "--width", str(w), "--height", str(h),
        "--max-bounces", "50", "--spp", str(spp), "--spf", str(spf),
        "--out", os.path.join(tmp, "book.png"), "--checkpoint", ck])
    acc = _radiance(ck, w, h, spp)
    mean = float(np.sqrt(acc / spp).mean())
    # A lit sky-and-ground scene: a black or blown-out image is a failure.
    check(0.2 < mean < 0.9, f"book_one_final display mean {mean:.4f}")
    first = re.search(r"first frame ([\d.]+)s", err)
    later = re.search(r"later frames ([\d.]+) Mrays/s in ([\d.]+)s", err)
    check(first is not None and later is not None,
          "cli did not report its frame timings")
    first_s, mrays, later_s = (float(first.group(1)), float(later.group(1)),
                               float(later.group(2)))
    compile_s = first_s - later_s / (spp // spf - 1)
    log(json.dumps({"phase": "main_path", "config": f"{w}x{h}@{spp}spp/"
                    f"spf{spf}", "display_mean": mean,
                    "mrays_per_s": mrays, "warm_frames_s": later_s,
                    "wall_s": wall, "compile_s_est": compile_s}))


def phase_correctness() -> None:
    import numpy as np

    from wavefront_path_tracer_tpu import validate
    from wavefront_path_tracer_tpu.renderer import render
    from wavefront_path_tracer_tpu.scene import CameraController
    from wavefront_path_tracer_tpu.scene.scene import get_scene
    from wavefront_path_tracer_tpu.utils.config import (
        ENGINES, INTERSECTORS, RenderConfig)

    for engine in ENGINES:
        for intersector in INTERSECTORS:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = validate.main([
                    "--spp", "1000", "--engine", engine,
                    "--intersector", intersector,
                    "--oracle-cache", GOLDEN, "--gate", str(GATE)])
            rec = json.loads(out.getvalue().strip().splitlines()[-1])
            log(json.dumps({"phase": "correctness", **rec}))
            check(rc == 0 and rec["rmse"] < GATE,
                  f"{engine}/{intersector}: RMSE {rec['rmse']} vs the "
                  f"golden, gate {GATE}")

    # Engine agreement on the card: same RNG streams, same intersector.
    scene = get_scene("book_one_final")
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=8,
                       samples_per_frame=8, max_bounces=50,
                       intersector="bvh")
    wf = render(scene, cc, cfg.replace(engine="wavefront")).accumulated
    mk = render(scene, cc, cfg.replace(engine="megakernel")).accumulated
    diff = np.abs(wf - mk)
    log(json.dumps({"phase": "engine_agreement",
                    "config": "400x225@8spp/bvh",
                    "max_abs_diff": float(diff.max()),
                    "pixels_differing": int((diff.max(axis=-1) > 0).sum())}))


def phase_mesh(tmp: str) -> None:
    import numpy as np

    w, h, spp = 800, 448, 8
    ck = os.path.join(tmp, "terrain.npz")
    _, wall = _run_cli([
        "--scene", "mesh_terrain", "--intersector", "bvh",
        "--width", str(w), "--height", str(h), "--spp", str(spp),
        "--spf", str(spp), "--out", os.path.join(tmp, "terrain.png"),
        "--checkpoint", ck])
    acc = _radiance(ck, w, h, spp)
    log(json.dumps({"phase": "mesh", "config": f"{w}x{h}@{spp}spp/bvh",
                    "display_mean": float(np.sqrt(acc / spp).mean()),
                    "wall_s": wall}))


def _compare(a, b) -> dict:
    import numpy as np

    diff = np.abs(a - b)
    return {"max_abs_diff": float(diff.max()),
            "pixels_differing": int((diff.max(axis=-1) > 0).sum()),
            "mean_abs_diff": float(diff.mean())}


def phase_multi_gpu() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from wavefront_path_tracer_tpu.models import get_engine
    from wavefront_path_tracer_tpu.parallel.sharding import (
        make_mesh, render_samples_sharded)
    from wavefront_path_tracer_tpu.renderer import prepare_scene
    from wavefront_path_tracer_tpu.scene import CameraController
    from wavefront_path_tracer_tpu.scene.scene import get_scene
    from wavefront_path_tracer_tpu.utils.config import RenderConfig
    from wavefront_path_tracer_tpu.utils.image import rmse

    check(len(jax.devices()) == 4,
          f"--multi-gpu needs 4 cards, found {len(jax.devices())}")
    spp = 16
    cfg = RenderConfig(width=1920, height=1080, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50)
    cc = CameraController.book_one_final()
    arrays = prepare_scene(get_scene("book_one_final"), cfg)
    cam = cc.gpu_camera()
    view = jnp.asarray(cc.view_matrix())
    inv_proj = jnp.asarray(cc.inverse_projection(cfg.width, cfg.height))
    zero = jnp.uint32(0)
    label = (f"{cfg.width}x{cfg.height}@{spp}spp/{cfg.engine}/"
             f"{cfg.intersector}")

    def display(rad):
        return np.sqrt(np.clip(rad / spp, 0.0, None))

    t0 = time.perf_counter()
    frame, _ = get_engine(cfg.engine).render_samples(
        arrays, cam, view, inv_proj, cfg, zero, zero, spp)
    frame = np.asarray(frame)
    log(json.dumps({"phase": "one_card", "config": label,
                    "wall_s_incl_compile": time.perf_counter() - t0}))
    check(bool(np.isfinite(frame).all()), "one-card render not finite")
    for tiles, samples in ((4, 1), (2, 2)):
        mesh = make_mesh(4, sample_axis=samples)
        step = jax.jit(lambda a, v, ip: render_samples_sharded(
            mesh, a, cam, v, ip, cfg, zero, zero, spp))
        t0 = time.perf_counter()
        rad = np.asarray(step(arrays, view, inv_proj))
        wall = time.perf_counter() - t0
        check(bool(np.isfinite(rad).all()),
              f"{tiles}x{samples} render not finite")
        err = rmse(display(rad), display(frame))
        log(json.dumps({"phase": "sharded", "mesh": f"{tiles}x{samples}",
                        "config": label, "wall_s_incl_compile": wall,
                        **_compare(rad, frame), "display_rmse": err}))
        check(err < GATE, f"{tiles}x{samples} mesh image differs from the "
              f"one-card image: display RMSE {err}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi-gpu", action="store_true",
                   help="run only the 4-card sharded render phase")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (jax platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from wavefront_path_tracer_tpu.utils.device import device_info

    info = device_info()
    check(info["smi"] is not None, "nvidia-smi is not available")
    log(f"card: {info['smi']}")
    log(json.dumps({"phase": "device", **info}))

    t0 = time.perf_counter()
    if args.multi_gpu:
        phase_multi_gpu()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_main_path(tmp)
            phase_correctness()
            phase_mesh(tmp)
    log(f"smoke phases done in {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
