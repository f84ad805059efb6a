"""CLI app surface: config file, progress modes, multi-channel.

Mirrors the reference app layers (ref Source/App/app_config.c config
file + token table, app_process_cmd.c:962 progress modes,
app_main.c:153 multi-channel instances).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "clip.y4m"
    subprocess.run([sys.executable,
                    os.path.join(_ROOT, "tools", "make_test_clip.py"),
                    "--width", "192", "--height", "128", "--frames", "4",
                    str(p)], check=True)
    return str(p)


def _run(args, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.abspath(_ROOT))
    return subprocess.run([sys.executable, "-m", "svt_av1_psy_tpu"] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_config_file_and_progress3(clip, tmp_path):
    cfg = tmp_path / "enc.cfg"
    cfg.write_text("# comment\ncrf 35\npreset 12\nprogress 3\nframes 4\n")
    out = tmp_path / "out.ivf"
    r = _run(["-i", clip, "-b", str(out), "-c", str(cfg)])
    assert r.returncode == 0, r.stderr
    assert "ETA" in r.stderr, "progress 3 must print ETA"
    assert out.stat().st_size > 100
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf as dav
    assert len(dav(out.read_bytes())) == 4


def test_multi_channel(clip, tmp_path):
    o1, o2 = tmp_path / "a.ivf", tmp_path / "b.ivf"
    r = _run(["--nch", "2", "-i", f"{clip},{clip}",
              "-b", f"{o1},{o2}", "--preset", "12", "--crf", "35",
              "--progress", "0"], timeout=400)
    assert r.returncode == 0, r.stderr
    assert o1.read_bytes() == o2.read_bytes() != b""


def test_progress_0_is_quiet(clip, tmp_path):
    out = tmp_path / "q.ivf"
    r = _run(["-i", clip, "-b", str(out), "--preset", "12", "--crf", "35",
              "--progress", "0"])
    assert r.returncode == 0, r.stderr
    assert "Encoding frame" not in r.stderr
