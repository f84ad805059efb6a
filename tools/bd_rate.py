#!/usr/bin/env python
"""BD-rate harness: our encoder vs the reference SvtAv1EncApp.

Encodes a clip at several operating points with both encoders, decodes
with dav1d, and reports (bitrate, PSNR) pairs + BD-rate (the
Bjontegaard delta computed with piecewise-cubic interpolation, the
standard metric the reference's CI uses for quality gating).

Usage:
    python tools/bd_rate.py --clip /tmp/clip_1080.y4m --frames 16 \
        --ref-bin /tmp/refbin/Bin/Release/SvtAv1EncApp \
        --crfs 25,32,39,46 --out QUALITY_r02.json
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def psnr_stream(ivf_path, src_frames):
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf
    dfs = decode_ivf(ivf_path)
    n = min(len(dfs), len(src_frames))
    m_y = m_u = m_v = 0.0
    for i in range(n):
        sy, su, sv = src_frames[i]
        m_y += np.mean((sy.astype(np.float64) - dfs[i].y) ** 2)
        m_u += np.mean((su.astype(np.float64) - dfs[i].u) ** 2)
        m_v += np.mean((sv.astype(np.float64) - dfs[i].v) ** 2)
    m_y, m_u, m_v = m_y / n, m_u / n, m_v / n
    peak = 255.0 * 255.0

    def db(m):
        return 10 * math.log10(peak / max(m, 1e-9))

    # 6/1/1 weighted (libaom convention for combined PSNR)
    return db(m_y), db((6 * m_y + m_u + m_v) / 8.0)


def bd_rate(r1, p1, r2, p2):
    """BD-rate of curve 2 vs curve 1 (negative = curve 2 better).
    r: bitrates (kbps), p: quality (dB). Piecewise-linear in log-rate
    over the overlapping quality range (robust to flat/crossing curves
    where the classic cubic fit explodes)."""
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    if hi - lo < 0.3:
        return float("nan")
    samples = np.linspace(lo, hi, 200)

    def interp(p, r):
        p = np.asarray(p, float)
        lr = np.log(np.asarray(r, float))
        idx = np.argsort(p)
        return np.interp(samples, p[idx], lr[idx])

    avg_exp_diff = np.mean(interp(p2, r2) - interp(p1, r1))
    return float((math.exp(avg_exp_diff) - 1) * 100)


def read_clip(path, n):
    from svt_av1_psy_tpu.io.y4m import Y4mReader
    rd = Y4mReader(path)
    out = []
    for _ in range(n):
        f = rd.read_frame()
        if f is None:
            break
        out.append(f)
    return out


def encode_ours(src, w, h, crf, fps_hz, preset, gop=1, params=""):
    """Production-path encode via api.Encoder (the same configuration
    the CLI/C-API produce; gop: 1 = all intra, 0 = flat low delay,
    -1 = random access pyramid). params: svtav1-params key=value string
    applied on top (film-grain, tune, variance boost, ...)."""
    import time

    from svt_av1_psy_tpu.api import Encoder
    from svt_av1_psy_tpu.bitstream.ivf import IvfWriter
    from svt_av1_psy_tpu.config import (EncoderConfig, PredStructure,
                                        parse_parameter_string)

    cfg = EncoderConfig(
        enc_mode=preset, qp=crf,
        intra_period_length=(0 if gop == 1 else -1),
        hierarchical_levels=(5 if gop == -1 and preset <= 12 else 0),
        pred_structure=(PredStructure.RANDOM_ACCESS if gop == -1
                        else PredStructure.LOW_DELAY_B))
    if params:
        cfg = parse_parameter_string(cfg, params)
    enc = Encoder(cfg, w, h, bit_depth=8)
    tmp = tempfile.mktemp(suffix=".ivf")
    wtr = IvfWriter(tmp, w, h)
    total = 0
    npkt = 0
    t0 = time.time()
    pkts = []
    for f in src:
        pkts.extend(enc.send_picture(*f))
    pkts.extend(enc.flush())
    for p in pkts:
        wtr.write_frame(p.payload, npkt)
        total += len(p.payload)
        npkt += 1
    wtr.close()
    dt = time.time() - t0
    return tmp, total, len(src) / dt


def encode_ref(ref_bin, clip, n, crf, preset, gop=1, ref_args=()):
    tmp = tempfile.mktemp(suffix=".ivf")
    env = dict(os.environ, LD_LIBRARY_PATH=os.path.dirname(ref_bin))
    cmd = [ref_bin, "-i", clip, "-b", tmp, "--preset", str(preset),
           "--crf", str(crf), "-n", str(n)]
    if gop == 1:
        cmd += ["--keyint", "1"]
    elif gop == -1:
        cmd += ["--keyint", str(n), "--tune", "1"]   # RA (default struct)
    else:
        cmd += ["--pred-struct", "1", "--tune", "1"]
    cmd += list(ref_args)
    subprocess.run(cmd, env=env, capture_output=True, check=True)
    return tmp, os.path.getsize(tmp)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", required=True)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--ref-bin", default="/tmp/refbin/SvtAv1EncApp")
    ap.add_argument("--crfs", default="25,32,39,46")
    ap.add_argument("--preset", type=int, default=12)
    ap.add_argument("--our-preset", type=int, default=12)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--gop", type=int, default=1,
                    help="1 = all-intra; 0 = low-delay IPPP; -1 = RA")
    ap.add_argument("--params", default="",
                    help="svtav1-params string for OUR encoder "
                         "(film-grain=8:tune=3:...)")
    ap.add_argument("--ref-args", default="",
                    help="extra raw args for the reference app "
                         "(space-separated)")
    ap.add_argument("--tag", default="",
                    help="result key suffix (content class / config id)")
    args = ap.parse_args()

    src = read_clip(args.clip, args.frames)
    h, w = src[0][0].shape
    n = len(src)
    crfs = [int(x) for x in args.crfs.split(",")]

    ref_pts = []
    for crf in crfs:
        path, size = encode_ref(args.ref_bin, args.clip, n, crf,
                                args.preset, args.gop,
                                args.ref_args.split())
        py, pyuv = psnr_stream(path, src)
        kbps = size * 8 * args.fps / n / 1000
        ref_pts.append({"crf": crf, "kbps": kbps, "psnr_y": py,
                        "psnr_yuv": pyuv})
        print(f"ref  crf{crf}: {kbps:9.1f} kbps  {py:.2f} dB-Y", flush=True)

    our_pts = []
    for crf in crfs:
        path, size, fps_enc = encode_ours(src, w, h, crf, args.fps,
                                          args.our_preset, args.gop,
                                          args.params)
        py, pyuv = psnr_stream(path, src)
        kbps = size * 8 * args.fps / n / 1000
        our_pts.append({"crf": crf, "kbps": kbps, "psnr_y": py,
                        "psnr_yuv": pyuv, "enc_fps": round(fps_enc, 2)})
        print(f"ours crf{crf}:  {kbps:9.1f} kbps  {py:.2f} dB-Y  "
              f"({fps_enc:.2f} fps)", flush=True)

    bd_y = bd_rate([p["kbps"] for p in ref_pts],
                   [p["psnr_y"] for p in ref_pts],
                   [p["kbps"] for p in our_pts],
                   [p["psnr_y"] for p in our_pts])
    bd_yuv = bd_rate([p["kbps"] for p in ref_pts],
                     [p["psnr_yuv"] for p in ref_pts],
                     [p["kbps"] for p in our_pts],
                     [p["psnr_yuv"] for p in our_pts])
    print(f"BD-rate (PSNR-Y):   {bd_y:+.1f}%  (negative = ours better)")
    print(f"BD-rate (PSNR-YUV): {bd_yuv:+.1f}%")
    def _num(v):
        return None if (v != v) else round(v, 2)   # NaN -> null (strict JSON)
    result = {"clip": args.clip, "frames": n,
              "ref_preset": args.preset, "our_preset": args.our_preset,
              "ref": ref_pts, "ours": our_pts,
              "bd_rate_psnr_y_pct": _num(bd_y),
              "bd_rate_psnr_yuv_pct": _num(bd_yuv)}
    if bd_y != bd_y:
        result["note"] = ("quality ranges barely overlap: compare the "
                          "per-point (kbps, dB) pairs directly")
    if args.out:
        existing = {}
        if os.path.exists(args.out):
            try:
                existing = json.loads(open(args.out).read())
            except Exception:
                existing = {}
        key = os.path.basename(args.clip) + \
            ("_ra" if args.gop == -1 else
             "_lowdelay" if args.gop != 1 else "")
        if args.tag:
            key += "_" + args.tag
        existing[key] = result
        open(args.out, "w").write(json.dumps(existing, indent=1))
    return 0


if __name__ == "__main__":
    from svt_av1_psy_tpu.utils.device import select_platform
    select_platform()
    raise SystemExit(main())
