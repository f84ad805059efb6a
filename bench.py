#!/usr/bin/env python
"""Benchmark: REAL full-encode throughput at the north-star config.

Primary metric: frames/s of a complete 1080p preset-6 CRF-30 random-access
encode (device GoP search + TF + TPL + native commit walks + entropy
coding + container) over 64 frames — the BASELINE.md scoring shape.
vs_baseline compares against the reference SvtAv1EncApp at the same config
as measured on a 4-core CPU host (BASELINE_MEASURED.json:
northstar_1080p_p6_crf30, 64-frame clips from the same generator); it is
history, not a ratio on this host.

detail.secondary carries the 1080p all-intra preset-12 number against its
own measured reference baseline (the round-1..3 metric, for continuity).

Prints ONE JSON line; detail names the platform, device kind, device count
and the card's power limit. Runs on the GPU unless JAX_PLATFORMS names
cpu; a missing device is an error, never a fallback (utils/device.py).
"""

import json
import os
import pathlib
import time

import numpy as np

ROOT = pathlib.Path(__file__).parent
W, H = 1920, 1080


def make_frames(n):
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    from make_test_clip import make_frame
    rng = np.random.default_rng(7)
    return [make_frame(W, H, t, 8, 0.02, rng) for t in range(n)]


def bench_northstar(frames):
    """1080p preset 6 CRF 30 random access (TF + TPL on), one key frame —
    the reference's default prediction structure at this keyint."""
    from svt_av1_psy_tpu.api import Encoder
    from svt_av1_psy_tpu.config import EncoderConfig

    cfg = EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                        hierarchical_levels=5, tf_strength=1,
                        enable_tpl_la=1)
    enc = Encoder(cfg, W, H, bit_depth=8)
    t0 = time.perf_counter()
    total = 0
    nshown = 0
    for f in frames:
        for p in enc.send_picture(*f):
            total += len(p.payload)
            nshown += p.display_idx >= 0
    for p in enc.flush():
        total += len(p.payload)
        nshown += p.display_idx >= 0
    dt = time.perf_counter() - t0
    enc.close()
    assert nshown == len(frames)
    return len(frames) / dt, total


def bench_allintra(frames):
    """1080p preset-12 all-intra (the round-1..3 continuity metric)."""
    from svt_av1_psy_tpu.models.fast_intra import FastIntraEncoder

    enc = FastIntraEncoder(W, H, qindex=140, n_cands=2)
    enc.tx_split_search = True    # preset-12 feature set (api.py)
    enc.encode_frame(*frames[0])  # warmup: jit compile + native build
    enc.prefetch_decide(frames[0][0])
    t0 = time.perf_counter()
    total = 0
    for i, f in enumerate(frames):
        if i + 1 < len(frames):
            enc.prefetch_decide(frames[i + 1][0])
        out = enc.encode_frame(*f)
        total += len(out.payload)
    dt = time.perf_counter() - t0
    enc.close()
    return len(frames) / dt, total


def main():
    import jax

    from svt_av1_psy_tpu.utils.device import (gpu_name_and_power_limit,
                                              select_platform)
    plat = select_platform()
    dev = jax.devices()[0]

    n_ns = int(os.environ.get("SVT_BENCH_FRAMES", "64"))
    frames = make_frames(n_ns)

    n_ai = min(16, n_ns)
    fps_ai, bytes_ai = bench_allintra(frames[:n_ai])
    fps_ns, bytes_ns = bench_northstar(frames)

    ref = {}
    bm = ROOT / "BASELINE_MEASURED.json"
    if bm.exists():
        ref = json.loads(bm.read_text())["reference"]
    base_ns = ref.get("northstar_1080p_p6_crf30", {}).get("fps", 0.0)
    base_ai = ref.get("p12_1080p_crf35_allintra", {}).get("fps", 0.0)

    print(json.dumps({
        "metric": "full_encode_fps_1080p_p6_crf30_ra",
        "value": round(fps_ns, 3),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps_ns / base_ns, 3) if base_ns else 0.0,
        "detail": {
            "platform": plat,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": gpu_name_and_power_limit() if plat == "gpu" else None,
            "frames": n_ns,
            "bytes_per_frame": bytes_ns // n_ns,
            "baseline_ref": "SvtAv1EncApp p6 RA crf30 1080p 64f "
                            "(measured, BASELINE_MEASURED.json)",
            "baseline_fps": base_ns,
            "secondary": {
                "metric": "full_encode_fps_1080p_allintra_p12",
                "value": round(fps_ai, 3),
                "vs_baseline": round(fps_ai / base_ai, 3)
                if base_ai else 0.0,
                "baseline_fps": base_ai,
                "bytes_per_frame": bytes_ai // n_ai,
            },
        },
    }))


if __name__ == "__main__":
    main()
