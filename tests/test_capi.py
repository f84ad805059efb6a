"""Public C API (native/capi.h — the EbSvtAv1Enc.h analog).

Builds libsvtav1_tpu.so (embedded-CPython shim over api.Encoder) and
drives the full lifecycle init_handle -> set_parameter ->
parse_parameter -> init -> send_picture -> get_packet -> deinit from C
calling conventions (via ctypes), validating the output with dav1d.
"""
import ctypes
import io
import os
import sys

import numpy as np
import pytest

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_ROOT, "tools"))


class Cfg(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("bit_depth", ctypes.c_int32), ("enc_mode", ctypes.c_int32),
                ("crf", ctypes.c_double), ("intra_period", ctypes.c_int32),
                ("frame_rate", ctypes.c_int32),
                ("tile_columns", ctypes.c_int32),
                ("hierarchical_levels", ctypes.c_int32),
                ("pred_structure", ctypes.c_int32)]


@pytest.fixture(scope="module")
def lib():
    from build_capi import build
    so = build()
    lib = ctypes.CDLL(str(so))
    lib.svt_tpu_enc_init_handle.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_set_parameter.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(Cfg)]
    lib.svt_tpu_enc_parse_parameter.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
    lib.svt_tpu_enc_init.argtypes = [ctypes.c_void_p]
    lib.svt_tpu_enc_stream_header.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.svt_tpu_enc_send_picture.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32]
    lib.svt_tpu_enc_get_packet.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int64)]
    lib.svt_tpu_enc_deinit.argtypes = [ctypes.c_void_p]
    return lib


def test_capi_lifecycle(lib):
    from make_test_clip import make_frame
    h = ctypes.c_void_p()
    cfg = Cfg()
    assert lib.svt_tpu_enc_init_handle(ctypes.byref(h),
                                       ctypes.byref(cfg)) == 0
    assert cfg.enc_mode == 8 and cfg.bit_depth == 8   # defaults filled
    cfg.width, cfg.height = 192, 128
    cfg.enc_mode, cfg.crf, cfg.intra_period = 12, 35.0, 0
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == 0
    assert lib.svt_tpu_enc_parse_parameter(
        h, b"enable-variance-boost=1") == 0
    assert lib.svt_tpu_enc_init(h) == 0

    data = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    pts = ctypes.c_int64()
    assert lib.svt_tpu_enc_stream_header(h, ctypes.byref(data),
                                         ctypes.byref(size)) == 0
    assert size.value > 4

    payloads = []

    def drain():
        while lib.svt_tpu_enc_get_packet(h, ctypes.byref(data),
                                         ctypes.byref(size),
                                         ctypes.byref(pts)) == 0:
            raw = ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * size.value)).contents
            payloads.append((bytes(bytearray(raw)), pts.value))

    for t in range(3):
        y, u, v = make_frame(192, 128, t, 8, 0.0)
        y = np.ascontiguousarray(y)
        u = np.ascontiguousarray(u)
        v = np.ascontiguousarray(v)
        assert lib.svt_tpu_enc_send_picture(
            h, y.ctypes.data, y.shape[1], u.ctypes.data, v.ctypes.data,
            u.shape[1]) == 0
        drain()
    assert lib.svt_tpu_enc_send_picture(h, None, 0, None, None, 0) == 0
    drain()
    lib.svt_tpu_enc_deinit(h)

    assert len(payloads) == 3
    from svt_av1_psy_tpu.bitstream.ivf import IvfWriter
    buf = io.BytesIO()
    w = IvfWriter(buf, 192, 128)
    for i, (p, _) in enumerate(payloads):
        w.write_frame(p, i)
    w.close()
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf as dav
    assert len(dav(buf.getvalue())) == 3


def test_capi_rejects_bad_params(lib):
    h = ctypes.c_void_p()
    cfg = Cfg()
    assert lib.svt_tpu_enc_init_handle(ctypes.byref(h),
                                       ctypes.byref(cfg)) == 0
    cfg.width, cfg.height = 191, 128          # odd width
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == -1
    cfg.width, cfg.height, cfg.bit_depth = 192, 128, 12
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == -1
    assert lib.svt_tpu_enc_set_parameter(h, None) == -1
    lib.svt_tpu_enc_deinit(h)


def test_capi_from_standalone_c_program(lib, tmp_path):
    """Compile + run a real C program against the library (the embedded
    interpreter path: Py_Initialize happens inside the .so)."""
    import subprocess
    import sysconfig
    demo = tmp_path / "demo.c"
    demo.write_text(r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "capi.h"
int main(void) {
    SvtTpuEncoder *h; SvtTpuConfig cfg;
    if (svt_tpu_enc_init_handle(&h, &cfg)) return 1;
    cfg.width = 128; cfg.height = 64; cfg.enc_mode = 12;
    cfg.crf = 40; cfg.intra_period = 0;
    if (svt_tpu_enc_set_parameter(h, &cfg)) return 2;
    if (svt_tpu_enc_init(h)) return 3;
    unsigned char *y = malloc(128 * 64), *u = malloc(64 * 32),
                  *v = malloc(64 * 32);
    for (int i = 0; i < 128 * 64; i++) y[i] = (i * 7) & 255;
    memset(u, 128, 64 * 32); memset(v, 100, 64 * 32);
    if (svt_tpu_enc_send_picture(h, y, 128, u, v, 64)) return 4;
    const uint8_t *data; size_t size; int64_t pts;
    if (svt_tpu_enc_get_packet(h, &data, &size, &pts)) return 5;
    printf("packet %zu bytes pts %lld\n", size, (long long)pts);
    svt_tpu_enc_deinit(h);
    return size > 50 ? 0 : 6;
}
''')
    exe = tmp_path / "demo"
    subprocess.run(["cc", "-O1", str(demo), "-o", str(exe),
                    f"-I{_ROOT}/native", f"-L{_ROOT}/native",
                    "-lsvtav1_tpu", f"-Wl,-rpath,{_ROOT}/native"],
                   check=True)
    env = dict(os.environ, PYTHONPATH=_ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    assert "packet" in r.stdout


def test_capi_vbr_tf_random_access(lib):
    """Library-level RC + TF + TPL through the .so (ref keeps RC/TF/TPL
    inside the library — rc_process.c:3269, temporal_filtering.c:4064):
    a VBR random-access encode driven purely via parse_parameter, no
    app-side orchestration. The stream must decode in dav1d and land
    near the requested average bitrate."""
    from make_test_clip import make_frame
    h = ctypes.c_void_p()
    cfg = Cfg()
    assert lib.svt_tpu_enc_init_handle(ctypes.byref(h),
                                       ctypes.byref(cfg)) == 0
    cfg.width, cfg.height = 192, 128
    cfg.enc_mode, cfg.crf = 8, 35.0
    cfg.intra_period = -1                  # one key, open GoP
    cfg.hierarchical_levels = 2            # 4-frame RA mini-GoPs
    cfg.pred_structure = 2
    assert lib.svt_tpu_enc_set_parameter(h, ctypes.byref(cfg)) == 0
    assert lib.svt_tpu_enc_parse_parameter(
        h, b"rc=1:tbr=200:enable-tf=1:enable-tpl-la=1") == 0
    assert lib.svt_tpu_enc_init(h) == 0

    data = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    pts = ctypes.c_int64()
    payloads = []

    def drain():
        while lib.svt_tpu_enc_get_packet(h, ctypes.byref(data),
                                         ctypes.byref(size),
                                         ctypes.byref(pts)) == 0:
            raw = ctypes.cast(
                data, ctypes.POINTER(ctypes.c_uint8 * size.value)).contents
            payloads.append((bytes(bytearray(raw)), pts.value))

    n = 13
    for t in range(n):
        y, u, v = make_frame(192, 128, t, 8, 0.02)
        y = np.ascontiguousarray(y)
        u = np.ascontiguousarray(u)
        v = np.ascontiguousarray(v)
        assert lib.svt_tpu_enc_send_picture(
            h, y.ctypes.data, y.shape[1], u.ctypes.data, v.ctypes.data,
            u.shape[1]) == 0
        drain()
    assert lib.svt_tpu_enc_send_picture(h, None, 0, None, None, 0) == 0
    drain()
    lib.svt_tpu_enc_deinit(h)

    shown = [p for p, d in payloads if d >= 0]
    assert len(shown) == n
    stream = b"".join(p for p, _ in payloads)
    from svt_av1_psy_tpu.decoder.dav1d import decode_obus
    assert len(decode_obus(stream)) == n
    # VBR convergence: within 3x of the 200 kbps target on this tiny
    # clip (the controller needs frames to converge; the point is that
    # RC demonstrably ran inside the library)
    kbps = sum(len(p) for p, _ in payloads) * 8 * 30 / n / 1000
    assert 40 < kbps < 600, kbps
