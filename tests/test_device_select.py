"""Platform choice, compile-cache placement and the chip smoke test's
refusal to run without a GPU (utils/device.py, chip_smoke.py)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from svt_av1_psy_tpu.utils.device import (CHECKOUT, configure_compile_cache,
                                          select_platform)

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set(monkeypatch, tmp_path, cache_dir_restored):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands and the
    program sets no directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_env_unset(monkeypatch, cache_dir_restored):
    """Unset: the encoder's constructor places the cache in the
    checkout's .jax_cache, which git ignores."""
    from svt_av1_psy_tpu.models.fast_intra import FastIntraEncoder

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    FastIntraEncoder(64, 64, qindex=100)
    path = str(CHECKOUT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert configure_compile_cache() == path
    ignored = (CHECKOUT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_select_platform_gpu_without_gpu_raises():
    with pytest.raises(RuntimeError, match="no gpu device"):
        select_platform("gpu")


def test_select_platform_cpu_and_bad_name():
    assert select_platform("cpu") == "cpu"
    with pytest.raises(ValueError):
        select_platform("tpu")


def test_cli_device_gpu_fails_without_gpu(tmp_path, capsys):
    from svt_av1_psy_tpu.app.cli import main

    rc = main(["-i", str(tmp_path / "in.y4m"), "-b",
               str(tmp_path / "out.ivf"), "--device", "gpu"])
    assert rc != 0
    assert "no gpu device" in capsys.readouterr().err
    assert not (tmp_path / "out.ivf").exists()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """Under JAX_PLATFORMS=cpu, or copied out of the checkout, the chip
    smoke test exits non-zero and prints no result line."""
    script = os.path.join(_ROOT, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
