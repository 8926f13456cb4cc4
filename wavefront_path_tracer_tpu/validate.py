"""Correctness gate: RMSE between an engine under test and the oracle.

The BASELINE acceptance criterion is "< 1e-3 RMSE vs CPU oracle images"
(BASELINE.md); this tool renders the same configuration with the
megakernel oracle and the engine under test — each optionally pinned to
a platform — and reports the display-image RMSE plus convergence stats.

The BASELINE-exact flow renders the oracle ONCE on CPU into a golden
artifact, then gates the engine on the GPU against it::

    # 1. produce the golden image (CPU-only process)
    python -m wavefront_path_tracer_tpu.validate --platform cpu \
        --spp 1000 --oracle-only --oracle-cache golden/oracle_400x225_1000.npz

    # 2. gate the default engine on the GPU against it
    python -m wavefront_path_tracer_tpu.validate --spp 1000 \
        --oracle-cache golden/oracle_400x225_1000.npz

Exit code 0 iff RMSE < --gate (default 1e-3).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from wavefront_path_tracer_tpu.utils.config import (
    DEFAULT_ENGINE,
    DEFAULT_INTERSECTOR,
    ENGINES,
    INTERSECTORS,
    RenderConfig,
)


@contextlib.contextmanager
def _device_ctx(platform: str | None):
    """Pin subsequent jits to the first device of ``platform`` (the
    whole-process jax_platforms config cannot be switched per render).

    When that pins a CPU device inside a GPU-default process, the
    persistent compile cache is suspended for the duration:
    ``compile_cache.activate()`` gates on the *default* backend only,
    and persisted XLA:CPU executables are the native-crash class the
    cache module exists to avoid (see utils/compile_cache.py).
    """
    if platform is None:
        yield
        return
    import jax

    dev = jax.devices(platform)[0]
    if dev.platform == "cpu" and jax.default_backend() != "cpu":
        # Make the once-per-process activation decision NOW (from the
        # real default backend) so a prepare_scene() inside this scope
        # cannot re-attach the cache mid-suspension — and so ``prev``
        # restores the attached dir for later GPU renders.
        from wavefront_path_tracer_tpu.utils import compile_cache

        compile_cache.activate()
        prev = jax.config.jax_compilation_cache_dir
        try:
            jax.config.update("jax_compilation_cache_dir", None)
            with jax.default_device(dev):
                yield
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)
    else:
        with jax.default_device(dev):
            yield


def _oracle_meta(args) -> dict:
    meta = {
        "scene": args.scene, "width": args.width, "height": args.height,
        "spp": args.spp, "max_bounces": args.max_bounces,
        "engine": args.oracle_engine, "intersector": args.oracle_intersector,
    }
    # Recorded only when non-default so the pre-existing golden
    # artifacts' stored metadata (which predates the key) stays valid.
    sampler = _oracle_sampler(args)
    if sampler != "random":
        meta["sampler"] = sampler
    return meta


def _oracle_sampler(args) -> str:
    """The oracle's AA sampler.  Defaults to the TEST sampler: a
    sampler changes the estimator, and same-stream gates need both
    engines to integrate with the same estimator so MC noise cancels.
    Pass --oracle-sampler random to compare a variant sampler against
    a random-sampler oracle instead (an independent-quadrature BIAS
    gate — it floors at the MC noise, never at the numerics floor)."""
    return args.oracle_sampler or args.sampler


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="book_one_final")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=225)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--engine", default=DEFAULT_ENGINE, choices=ENGINES)
    p.add_argument("--intersector", default=DEFAULT_INTERSECTOR,
                   choices=INTERSECTORS)
    p.add_argument("--rr", type=int, default=0,
                   help="Russian roulette start bounce for the engine "
                        "under test (0 = off)")
    p.add_argument("--rr-floor", type=float, default=0.05,
                   help="roulette survival floor for the engine under test")
    p.add_argument("--material-split", action="store_true",
                   help="wavefront: partition the shade queue by material")
    p.add_argument("--sampler", default="random",
                   help="AA sampler for the engine under test "
                        "(random | stratified)")
    p.add_argument("--test-platform", default=None,
                   help="device platform for the engine under test "
                        "(cpu | gpu; default = process default)")
    p.add_argument("--oracle-engine", default="megakernel")
    p.add_argument("--oracle-intersector", default="bruteforce")
    p.add_argument("--oracle-sampler", default=None,
                   help="AA sampler for the oracle render (default: "
                        "the --sampler value, so same-stream gates "
                        "compare equal estimators)")
    p.add_argument("--oracle-platform", default=None,
                   help="device platform for the oracle render")
    p.add_argument("--oracle-spf", type=int, default=10,
                   help="oracle frame-batch size (the oracle's spp "
                        "budget runs in batches of this many samples)")
    p.add_argument("--oracle-cache", default=None,
                   help="npz golden artifact: loaded if present (metadata "
                        "validated), else the oracle render is saved to it")
    p.add_argument("--oracle-only", action="store_true",
                   help="produce/refresh the golden artifact and exit")
    p.add_argument("--platform", default=None,
                   help="force the whole process onto a platform "
                        "(e.g. cpu)")
    p.add_argument("--gate", type=float, default=1e-3)
    p.add_argument("--save-prefix", default=None,
                   help="write <prefix>_test.png / <prefix>_oracle.png")
    args = p.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from wavefront_path_tracer_tpu.renderer import render
    from wavefront_path_tracer_tpu.scene import CameraController
    from wavefront_path_tracer_tpu.scene.scene import get_scene
    from wavefront_path_tracer_tpu.utils.image import rmse, write_png

    scene = get_scene(args.scene)
    cc = CameraController.book_one_final()
    base = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, samples_per_frame=args.spp,
        max_bounces=args.max_bounces,
    )

    # --- oracle image: golden artifact or fresh render ---
    meta = _oracle_meta(args)
    oracle_image = None
    if args.oracle_cache and os.path.exists(args.oracle_cache):
        z = np.load(args.oracle_cache, allow_pickle=False)
        stored = json.loads(str(z["meta"]))
        if stored != meta:
            raise ValueError(
                f"golden artifact {args.oracle_cache} was rendered with "
                f"{stored}, but this gate needs {meta}; delete it or pass "
                "matching flags")
        oracle_image = z["image"]
        oracle_platform = str(z["platform"])
        print(f"loaded golden oracle ({oracle_platform}) from "
              f"{args.oracle_cache}", file=sys.stderr)
    else:
        t0 = time.time()
        with _device_ctx(args.oracle_platform):
            import jax

            oracle_platform = (args.oracle_platform
                               or jax.default_backend())
            oracle = render(scene, cc, base.replace(
                engine=args.oracle_engine,
                intersector=args.oracle_intersector,
                sampler=_oracle_sampler(args),
                samples_per_frame=min(args.oracle_spf, args.spp)))
        oracle_image = oracle.image
        print(f"oracle done in {time.time() - t0:.1f}s "
              f"({oracle_platform})", file=sys.stderr)
        if args.oracle_cache:
            os.makedirs(os.path.dirname(args.oracle_cache) or ".",
                        exist_ok=True)
            np.savez_compressed(
                args.oracle_cache, image=np.asarray(oracle_image),
                meta=np.asarray(json.dumps(meta)),
                platform=np.asarray(oracle_platform))
            print(f"saved golden oracle to {args.oracle_cache}",
                  file=sys.stderr)
    if args.oracle_only:
        return 0

    # --- engine under test ---
    t0 = time.time()
    with _device_ctx(args.test_platform):
        test = render(scene, cc, base.replace(
            engine=args.engine, intersector=args.intersector,
            rr_start_bounce=args.rr, rr_floor=args.rr_floor,
            material_split=args.material_split, sampler=args.sampler,
            samples_per_frame=min(args.spp, 200)))
    t_test = time.time() - t0
    print(f"test engine done in {t_test:.1f}s "
          f"({test.mrays_per_s:.1f} Mrays/s)", file=sys.stderr)

    err = rmse(test.image, oracle_image)
    if args.save_prefix:
        write_png(f"{args.save_prefix}_test.png", test.image)
        write_png(f"{args.save_prefix}_oracle.png", oracle_image)

    variant = "".join(
        f"/{tag}" for tag, on in (
            (f"rr{args.rr}", args.rr),
            ("matsplit", args.material_split),
            (args.sampler, args.sampler != "random"),
        ) if on)
    result = {
        "scene": args.scene,
        "config": f"{args.width}x{args.height}@{args.spp}spp",
        "engine": f"{args.engine}/{args.intersector}{variant}",
        "oracle": f"{args.oracle_engine}/{args.oracle_intersector}"
                  f"@{oracle_platform}",
        "rmse": err,
        "gate": args.gate,
        "pass": bool(err < args.gate),
        "test_mrays_per_s": round(test.mrays_per_s, 2),
    }
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
