#!/usr/bin/env python
"""Profile the north-star config: per-stage wall-clock (SVT_TRACE) +
native C phase buckets (SVT_NATIVE_PROF). Usage:
  python tools/profile_ns.py [n_frames] [preset]
Prints stage totals and the walk-time phase breakdown."""

import os
import pathlib
import sys
import time

os.environ.setdefault("SVT_NATIVE_PROF", "1")

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    preset = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    from make_test_clip import make_frame
    rng = np.random.default_rng(7)
    W, H = 1920, 1080
    frames = [make_frame(W, H, t, 8, 0.02, rng) for t in range(n)]

    # same platform choice as bench.py (the GPU unless JAX_PLATFORMS
    # names cpu; no fallback)
    from svt_av1_psy_tpu.utils.device import select_platform
    select_platform()

    from svt_av1_psy_tpu import native
    from svt_av1_psy_tpu.api import Encoder
    from svt_av1_psy_tpu.config import EncoderConfig
    from svt_av1_psy_tpu.utils import trace

    cfg = EncoderConfig(enc_mode=preset, qp=30, intra_period_length=-1,
                        hierarchical_levels=5, tf_strength=1,
                        enable_tpl_la=1)
    enc = Encoder(cfg, W, H, bit_depth=8)
    trace._SPANS.clear() if hasattr(trace, "_SPANS") else None
    native.prof_reset()
    t0 = time.perf_counter()
    total = 0
    for f in frames:
        for p in enc.send_picture(*f):
            total += len(p.payload)
    for p in enc.flush():
        total += len(p.payload)
    dt = time.perf_counter() - t0
    enc.close()
    print(f"fps={n / dt:.3f}  bytes={total}  wall={dt:.2f}s")
    prof = native.prof_get()
    walk = prof.get("trial_total", 0) + prof.get("commit_ec", 0)
    print("native buckets (ms, summed over tile threads):")
    for k, v in prof.items():
        print(f"  {k:12s} {v:10.1f}")
    hot = (prof["fwd_txfm"] + prof["quantize"] + prof["coeff_rate"])
    mc = sum(prof.get(k, 0) for k in ("mc_singleref", "mc_compound",
                                      "masked_search", "motion_modes"))
    tot = hot + mc
    if tot:
        print(f"  fwd+quant+rate = {hot:.1f} ms = "
              f"{100 * hot / tot:.1f}% of instrumented walk thread-time")
    cts = native.prof_trial_counts()
    if cts:
        txn = ("4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4",
               "8x16", "16x8", "16x32", "32x16", "32x64", "64x32",
               "4x16", "16x4", "8x32", "32x8", "16x64", "64x16")
        print("trial counts by tx size:")
        for i, v in sorted(cts.items()):
            print(f"  {txn[i]:7s} {v}")
    # stage spans (SVT_TRACE=1 must be set before import for these)
    s = trace.summary()
    if s:
        print("stage spans (ms):")
        for k, v in s.items():
            print(f"  {k:<20} total {v['total_ms']:>10.2f} x{v['calls']}")


if __name__ == "__main__":
    main()
