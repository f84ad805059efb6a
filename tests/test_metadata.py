"""HDR/T.35 metadata OBUs + logging subsystem (ref metadata_handle.c;
svt_log.c)."""
import io
import subprocess
import sys

import numpy as np

from svt_av1_psy_tpu.bitstream.metadata import (ContentLightLevel,
                                                MasteringDisplay,
                                                MetadataType,
                                                build_metadata_payload,
                                                parse_metadata_obu)
from svt_av1_psy_tpu.bitstream.obu import ObuType, parse_obus


def test_cll_roundtrip():
    obu = ContentLightLevel(1000, 400).obu()
    [(t, _, _, p)] = list(parse_obus(obu))
    assert t == ObuType.METADATA
    mtype, fields = parse_metadata_obu(p)
    assert mtype == MetadataType.HDR_CLL
    assert fields == {"max_cll": 1000, "max_fall": 400}


def test_mdcv_string_and_roundtrip():
    s = ("G(0.265,0.69)B(0.15,0.06)R(0.68,0.32)"
         "WP(0.3127,0.329)L(1000.0,0.005)")
    md = MasteringDisplay.parse(s)
    assert (md.gx, md.gy) == (0.265, 0.69)
    assert (md.rx, md.ry) == (0.68, 0.32)
    [(t, _, _, p)] = list(parse_obus(md.obu()))
    mtype, fields = parse_metadata_obu(p)
    assert mtype == MetadataType.HDR_MDCV
    # R first in the normative payload order
    assert fields["primaries"][0] == (round(0.68 * 65536),
                                      round(0.32 * 65536))
    assert abs(fields["max_luminance"] - 1000.0) < 0.01
    assert abs(fields["min_luminance"] - 0.005) < 0.001


def test_metadata_stream_decodes(tmp_path):
    """Streams carrying metadata OBUs stay decodable by dav1d and the
    own conformance decoder; metadata survives in the bitstream."""
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf as dav1d_decode
    from svt_av1_psy_tpu.decoder.driver import decode_ivf as own_decode
    from svt_av1_psy_tpu.io.y4m import Y4mWriter

    w, h, n = 176, 144, 4
    rng = np.random.default_rng(3)
    src = str(tmp_path / "in.y4m")
    with Y4mWriter(src, w, h) as wr:
        for t in range(n):
            y = rng.integers(0, 255, (h, w)).astype(np.uint8)
            u = np.full((h // 2, w // 2), 120, np.uint8)
            v = np.full((h // 2, w // 2), 130, np.uint8)
            wr.write_frame(y, u, v)
    t35 = str(tmp_path / "rpu.bin")
    with open(t35, "wb") as f:
        f.write(b"\xb5\x00\x3b\x00\x01\x04")    # T.35 country+payload
    out = str(tmp_path / "o.ivf")
    r = subprocess.run(
        [sys.executable, "-m", "svt_av1_psy_tpu", "-i", src, "-b", out,
         "--preset", "12", "--gop", "0", "--crf", "35",
         "--content-light", "1000,400",
         "--mastering-display",
         "G(0.265,0.69)B(0.15,0.06)R(0.68,0.32)WP(0.3127,0.329)"
         "L(1000.0,0.005)",
         "--t35-file", t35],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-500:]
    data = open(out, "rb").read()
    own = own_decode(data)
    dav = dav1d_decode(data)
    assert len(own) == len(dav) == n
    for a, b in zip(own, dav):
        assert np.array_equal(a.y, b.y)
    # metadata present: CLL+MDCV on the key TU, T.35 on every TU
    from svt_av1_psy_tpu.bitstream.ivf import read_ivf
    _, frames = read_ivf(data)
    types0 = [parse_metadata_obu(p)[0]
              for t, _, _, p in parse_obus(frames[0][1])
              if t == ObuType.METADATA]
    assert set(types0) == {MetadataType.HDR_CLL, MetadataType.HDR_MDCV,
                           MetadataType.ITUT_T35}
    for _, payload in frames[1:]:
        types = [parse_metadata_obu(p)[0]
                 for t, _, _, p in parse_obus(payload)
                 if t == ObuType.METADATA]
        assert types == [MetadataType.ITUT_T35]


def test_logging_levels(monkeypatch, capsys, tmp_path):
    import importlib

    from svt_av1_psy_tpu.utils import log as slog
    monkeypatch.setenv("SVT_LOG", "2")
    importlib.reload(slog)
    slog.warn("warned %d", 7)
    slog.info("hidden")
    err = capsys.readouterr().err
    assert "Svt[warn]: warned 7" in err and "hidden" not in err
    # file sink
    path = str(tmp_path / "log.txt")
    monkeypatch.setenv("SVT_LOG", "3")
    monkeypatch.setenv("SVT_LOG_FILE", path)
    importlib.reload(slog)
    slog.info("to file")
    assert "to file" in open(path).read()
    monkeypatch.delenv("SVT_LOG_FILE")
    importlib.reload(slog)


def test_fgs_table_roundtrip(tmp_path):
    """--fgs-table: parse the aom 'filmgrn1' text format into
    FilmGrainParams (ref App/app_config.c:2654 read_fgs_table)."""
    p = tmp_path / "t.fgs"
    p.write_text(
        "filmgrn1\n"
        "E 0 9223372036854775807 1 1234 1\n"
        "\tp 2 6 0 8 0 1 128 192 256 128 192 256\n"
        "\tsY 2  0 20 255 24\n"
        "\tsCb 1 0 8\n"
        "\tsCr 0\n"
        "\tcY 0 0 0 0 0 0 0 0 0 0 0 1\n"
        "\tcCb 0 0 0 0 0 0 0 0 0 0 0 0 0\n"
        "\tcCr 0 0 0 0 0 0 0 0 0 0 0 0 0\n")
    from svt_av1_psy_tpu.models.film_grain import load_fgs_table
    fg = load_fgs_table(str(p))
    assert fg.apply_grain and fg.grain_seed == 1234
    assert fg.scaling_y == [(0, 20), (255, 24)]
    assert fg.scaling_cb == [(0, 8)] and fg.scaling_cr == []
    assert fg.ar_coeff_lag == 2 and fg.ar_coeffs_y[-1] == 1
    assert len(fg.ar_coeffs_cb) == 13


def test_dolby_vision_rpu_per_frame(tmp_path):
    """--dolby-vision-rpu: per-display-frame T.35 payloads (the DoVi
    attach surface of ref app_process_cmd.c:463-495) land on their
    frames as ITU-T T.35 metadata OBUs."""
    import os
    import subprocess
    import sys as _sys

    _ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    clip = tmp_path / "c.y4m"
    subprocess.run([_sys.executable,
                    os.path.join(_ROOT, "tools", "make_test_clip.py"),
                    "--width", "192", "--height", "128", "--frames", "4",
                    str(clip)], check=True)
    rpu = tmp_path / "rpu.bin"
    payloads = [bytes([0xB5, 0x00, 0x3B, i, i + 1]) for i in range(4)]
    with open(rpu, "wb") as f:
        for p in payloads:
            f.write(len(p).to_bytes(4, "little"))
            f.write(p)
    out = tmp_path / "o.ivf"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.abspath(_ROOT))
    r = subprocess.run([_sys.executable, "-m", "svt_av1_psy_tpu",
                        "-i", str(clip), "-b", str(out),
                        "--preset", "12", "--crf", "35", "--keyint", "1",
                        "-n", "4", "--dolby-vision-rpu", str(rpu)],
                       capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, r.stderr
    data = open(out, "rb").read()
    # every per-frame payload must appear in the stream exactly once
    for p in payloads:
        assert data.count(p) == 1, p
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf
    assert len(decode_ivf(str(out))) == 4


def test_dolby_vision_rpu_beyond_128_frames():
    """RPU payloads key by TRUE display index: order hints wrap at 128,
    and a masked key would attach the wrong wrap's payload to every
    frame in a residue class (advisor finding, round 5)."""
    from svt_av1_psy_tpu.models.fast_intra import FastIntraEncoder

    enc = FastIntraEncoder(64, 64, qindex=100, bd=8)
    p0 = b"\xb5\x00\x3b\x00\x01"
    p130 = b"\xb5\x00\x3b\x82\x83"
    enc.metadata_per_frame = {0: p0, 130: p130}
    # display 130 wraps to order_hint 2; index 2 has NO payload, index
    # 130 has its own
    assert enc._per_frame_metadata(2) == b""
    assert enc._per_frame_metadata(130) == p130
    assert enc._per_frame_metadata(0) == p0
