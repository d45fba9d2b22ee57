"""Process-wide settings the package makes at import and at entry points:
matmul precision, the compilation-cache directory, and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import bemstokes_tpu
from bemstokes_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_matmul_precision_after_import():
    # "highest": f32 products stay f32 on a GPU instead of running in TF32
    assert bemstokes_tpu is not None
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_environment(
    monkeypatch, tmp_path, restore_cache_dir
):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_chip_smoke_refuses_the_cpu():
    proc = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_chip_smoke_needs_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
