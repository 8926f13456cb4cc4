"""Device and configuration plumbing: chip_smoke.py off the GPU, the
compile-cache location, the engine/intersector choice, the CLI's
device report."""

import os
import shutil
import subprocess
import sys

import pytest

from wavefront_path_tracer_tpu.utils import compile_cache
from wavefront_path_tracer_tpu.utils.config import (
    DEFAULT_ENGINE,
    DEFAULT_INTERSECTOR,
    ENGINES,
    INTERSECTORS,
    RenderConfig,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    """On a CPU-only process the smoke test exits non-zero and prints no
    ok line."""
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_compile_cache_env_var_wins():
    """JAX_COMPILATION_CACHE_DIR set: the module sets no directory."""
    env = {compile_cache.ENV_VAR: "/some/cache"}
    assert compile_cache.cache_dir(env) is None


def test_compile_cache_default_is_fixed_and_ignored():
    """Unset: one fixed directory inside the checkout, listed in
    .gitignore, whatever the working directory or HOME."""
    path = compile_cache.cache_dir({})
    assert path == compile_cache.DEFAULT_DIR
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert os.path.basename(path) + "/" in ignored
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == path


def test_compile_cache_never_attached_on_cpu(monkeypatch):
    import jax

    monkeypatch.setattr(compile_cache, "_activated", False)
    before = jax.config.jax_compilation_cache_dir
    compile_cache.activate()
    assert jax.config.jax_compilation_cache_dir == before
    assert compile_cache._activated


@pytest.mark.parametrize("field,value", [("engine", "fused"),
                                         ("intersector", "baked")])
def test_config_rejects_unknown_choices(field, value):
    with pytest.raises(ValueError, match=field):
        RenderConfig(**{field: value})


def test_engine_registry():
    from wavefront_path_tracer_tpu.models import get_engine

    assert DEFAULT_ENGINE in ENGINES and DEFAULT_INTERSECTOR in INTERSECTORS
    for name in ENGINES:
        assert hasattr(get_engine(name), "render_samples")
    with pytest.raises(KeyError):
        get_engine("fused")


def test_cli_reports_device(tmp_path, capsys):
    from wavefront_path_tracer_tpu.cli import main

    argv = ["--scene", "book_cover", "--width", "16", "--height", "8",
            "--spp", "1", "--max-bounces", "2", "--quiet",
            "--out", str(tmp_path / "o.png")]
    assert main(argv) == 0
    err = capsys.readouterr().err
    assert "device: platform=cpu" in err and "count=8" in err
