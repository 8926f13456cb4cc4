"""CLI end-to-end (in-process): render, checkpoint, resume, mesh, errors."""

import numpy as np
import pytest

from wavefront_path_tracer_tpu.cli import main
from wavefront_path_tracer_tpu.utils.image import read_png


def _args(tmp_path, *extra):
    return [
        "--scene", "book_cover", "--width", "32", "--height", "18",
        "--spp", "2", "--spf", "2", "--max-bounces", "4",
        "--engine", "megakernel",
        "--look-from", "-2", "2", "1", "--look-at", "0", "0", "-1",
        "--defocus-angle", "0", "--quiet",
        "--out", str(tmp_path / "out.png"), *extra,
    ]


def test_cli_renders_png(tmp_path):
    assert main(_args(tmp_path)) == 0
    img = read_png(str(tmp_path / "out.png"))
    assert img.shape == (18, 32, 3)
    assert img.mean() > 10  # not black


def test_cli_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.npz")
    assert main(_args(tmp_path, "--checkpoint", ck)) == 0
    # Resume with a larger budget: picks up at 2 spp, adds 2 more.
    argv = _args(tmp_path, "--resume", ck)
    argv[argv.index("--spp") + 1] = "4"
    assert main(argv) == 0


def test_cli_mesh_demo(tmp_path):
    argv = _args(tmp_path, )
    argv[argv.index("--scene") + 1] = "mesh_demo"
    argv[argv.index("--engine") + 1] = "wavefront"
    assert main(argv) == 0


def test_cli_obj(tmp_path):
    (tmp_path / "tri.obj").write_text("v 0 1 -2\nv 1 0 -2\nv -1 0 -2\nf 1 2 3\n")
    argv = _args(tmp_path, "--obj", str(tmp_path / "tri.obj"))
    argv[argv.index("--engine") + 1] = "wavefront"
    assert main(argv) == 0


def test_cli_budget_already_met(tmp_path):
    ck = str(tmp_path / "ck.npz")
    assert main(_args(tmp_path, "--checkpoint", ck)) == 0
    # Same spp budget, resuming from a finished checkpoint -> exit 1.
    assert main(_args(tmp_path, "--resume", ck)) == 1


def test_cli_preview_written_per_frame(tmp_path):
    prev = tmp_path / "prev.png"
    assert main(_args(tmp_path, "--preview", str(prev))) == 0
    img = read_png(str(prev))
    assert img.shape == (18, 32, 3)
    assert (tmp_path / "prev.html").exists()  # auto-refresh viewer


def test_cli_resume_rejects_mismatched_checkpoint(tmp_path):
    ck = str(tmp_path / "ck.npz")
    assert main(_args(tmp_path, "--checkpoint", ck)) == 0
    argv = _args(tmp_path, "--resume", ck)
    argv[argv.index("--width") + 1] = "64"  # different resolution
    argv[argv.index("--height") + 1] = "36"
    with pytest.raises(ValueError, match="refusing to blend"):
        main(argv)


def test_resolve_intersector_auto_policy():
    """'auto' resolves to the production default intersector (the
    measured fastest on an H100); explicit choices pass through."""
    from wavefront_path_tracer_tpu.cli import resolve_intersector
    from wavefront_path_tracer_tpu.utils.config import DEFAULT_INTERSECTOR

    it, notes = resolve_intersector("auto")
    assert it == DEFAULT_INTERSECTOR and notes
    for explicit in ("bvh", "bruteforce"):
        assert resolve_intersector(explicit) == (explicit, [])


def test_cli_aov(tmp_path):
    assert main(_args(tmp_path, "--aov", str(tmp_path / "p"))) == 0
    for suffix in ("aov.npz", "albedo.png", "normal.png", "depth.png"):
        assert (tmp_path / f"p.{suffix}").exists()
    d = np.load(tmp_path / "p.aov.npz")
    assert d["depth"].shape == (18, 32)
    assert 0.0 < d["coverage"].mean() <= 1.0
    assert (d["depth"][d["coverage"] > 0] > 0).all()


def test_cli_scene_default_camera(tmp_path):
    """Interior scenes get a sensible default view when no camera flags
    are passed (cornell from the book camera is a wall)."""
    from wavefront_path_tracer_tpu.cli import build_parser
    from wavefront_path_tracer_tpu.scene.scene import SCENE_CAMERAS

    argv = ["--scene", "cornell_spheres", "--width", "32", "--height",
            "18", "--spp", "2", "--spf", "2", "--max-bounces", "8",
            "--engine", "megakernel", "--quiet",
            "--out", str(tmp_path / "c.png")]
    assert main(argv) == 0
    img = read_png(str(tmp_path / "c.png"))
    # From the default interior view some rays see bright sky over the
    # open box; the old book-camera view is buried in a dark wall.
    assert img.max() > 150
    assert SCENE_CAMERAS["cornell_spheres"]["vfov"] == 36.0
    assert build_parser().get_default("vfov") is None


def test_cli_defaults_match_render_config():
    """Every CLI flag that maps onto a RenderConfig field must default
    to the RenderConfig default (or to None = "use the config default"),
    so the flags and the config cannot drift apart."""
    import dataclasses

    from wavefront_path_tracer_tpu.cli import build_parser
    from wavefront_path_tracer_tpu.utils.config import RenderConfig

    args = build_parser().parse_args([])
    cfg = RenderConfig()
    fields = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    mapping = {  # CLI dest -> RenderConfig field
        "width": "width", "height": "height",
        "spp": "samples_per_pixel", "spf": "samples_per_frame",
        "max_bounces": "max_bounces", "frame": "frame",
        "engine": "engine", "intersector": "intersector",
        "sampler": "sampler", "rr": "rr_start_bounce",
        "rr_floor": "rr_floor", "clamp": "clamp",
        "until_delta": "stop_delta",
    }
    for dest, field in mapping.items():
        cli_default = getattr(args, dest)
        if cli_default is None:
            continue  # None = defer to the RenderConfig default
        assert cli_default == fields[field], (
            f"--{dest.replace('_', '-')} defaults to {cli_default!r} but "
            f"RenderConfig.{field} defaults to {fields[field]!r}")
    assert (cfg.engine, cfg.intersector) == (args.engine, args.intersector)
