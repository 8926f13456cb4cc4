"""bench.py on the CPU: scene plumbing, device refusal, output fields.

These run tiny configs with ``--platform cpu`` — they check plumbing,
never throughput.  Without that flag the runner must refuse a device
that is not a GPU.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

from wavefront_path_tracer_tpu.utils.config import (  # noqa: E402
    ENGINES, INTERSECTORS)

TINY = ["--scene", "book_cover", "--width", "16", "--height", "8",
        "--spp", "1", "--max-bounces", "2", "--no-mesh-row"]


def test_bench_once_knot_scene_cpu():
    """The mesh_knot<N>k scene name builds a ground sphere + N*1000-ish
    triangle knot and frames it with the knot camera."""
    r = bench.bench_once("mesh_knot1k", 64, 32, 1, "megakernel",
                         "bruteforce", max_bounces=4)
    assert r["scene"] == "mesh_knot1k"
    assert r["rays"] > 64 * 32  # at least one bounce beyond primaries
    assert r["mrays_per_s"] > 0
    # The knot must actually be in frame: a miss-everything render has
    # exactly 2 rays/pixel (primary + ground bounce);  the knot adds
    # bounce depth.
    assert r["rays"] / (64 * 32) > 1.5


@pytest.mark.parametrize("intersector", INTERSECTORS)
@pytest.mark.parametrize("engine", ENGINES)
def test_bench_once_book_scene_cpu(engine, intersector):
    r = bench.bench_once("book_cover", 32, 16, 1, engine, intersector,
                         max_bounces=4)
    assert r["config"] == f"32x16@1spp/{engine}/{intersector}"
    assert r["mrays_per_s"] > 0 and r["first_call_seconds"] > 0


def test_bench_once_mesh_spec_cpu():
    """A 2x2 device mesh row reports pixel-samples/s (the sharded step
    returns radiance only)."""
    r = bench.bench_once("book_cover", 32, 16, 2, max_bounces=2,
                         mesh_spec=(2, 2))
    assert r["config"].endswith("/mesh2x2")
    assert r["rays"] is None and r["msamples_per_s"] > 0


def test_knot_tris_parsing():
    """Knot scene names parse strictly: the bare name means the 50k
    stress scene, '<N>k' scales it, and malformed suffixes are errors
    rather than silent 50k fallbacks (a typo'd row must not record a
    mislabeled measurement)."""
    assert bench.knot_tris("mesh_knot") == 50000
    assert bench.knot_tris("mesh_knot50k") == 50000
    assert bench.knot_tris("mesh_knot1k") == 1000
    for bad in ("mesh_knot500", "mesh_knotk", "mesh_knot5k0",
                "mesh_knot_5k"):
        with pytest.raises(ValueError):
            bench.knot_tris(bad)
    for key, scene, *_ in bench.MESH_ROWS:
        if scene.startswith("mesh_knot"):
            bench.knot_tris(scene)  # tracked rows must parse


def test_mesh_rows_spec_shape():
    """Every mesh row names a mesh scene and a real intersector."""
    for key, scene, w, h, spp, intersector in bench.MESH_ROWS:
        assert intersector in INTERSECTORS
        assert scene.startswith("mesh_")
        assert w * h > 0 and spp > 0


def test_bench_refuses_non_gpu(capsys):
    """On the CPU, without --platform cpu, nothing is reported."""
    assert bench.main(TINY) != 0
    assert capsys.readouterr().out == ""


def test_bench_json_line_device_fields(capsys):
    assert bench.main(TINY + ["--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["platform"] == "cpu" and rec["device_count"] == 8
    for key in ("device_kind", "name", "power_limit", "value", "unit",
                "seconds", "first_call_seconds"):
        assert key in rec
    assert rec["unit"] == "Mrays/s" and rec["value"] > 0


def test_bench_failed_config_exits_nonzero():
    """A configuration that fails makes the process fail: no fallback
    record, no JSON line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--platform", "cpu",
         "--scene", "no_such_scene", "--width", "8", "--height", "8",
         "--spp", "1", "--no-mesh-row"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "unknown scene" in proc.stderr
    assert proc.stdout.strip() == ""
