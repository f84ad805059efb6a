#!/usr/bin/env python
"""Smoke test of the encoder on one GPU, through its normal entry points.

    python chip_smoke.py

Phases, all in this one process (the decode oracles run in worker
processes that never import JAX); phase 3 runs first so that the in-repo
decode of its stream overlaps the others:

1. device: JAX's first device must be a GPU; prints its kind, the device
   count and the compile-cache directory.
2. device programs at 1080p (padded 1088x1920) on the GPU and on the CPU
   device: the integer programs bit-exact, the temporal filter and the
   Wiener LR search within their tolerances (svt_av1_psy_tpu/utils/
   parity.py); memory_analysis() of gop_search_tf at M = 16 and 32.
3. north-star encode through api.Encoder: 1080p 8-bit, preset 6, CRF 30,
   random access with 5 levels, TF and TPL on, LR on by preset; 33 frames
   (one key and one 32-frame mini-GoP: 5 levels are 2^5 frames).
4. preset-12 all-intra through api.Encoder, 8 frames at 1080p.
5. the CLI in-process (app.cli.main) on a 1080p y4m, 8 frames, preset 8,
   once alone and once with --nch 2.
6. the card-only tests: pytest -m gpu, in-process.

The streams of phases 3 and 4 must decode bit-exactly to the encoder's
recon in the in-repo decoder, and in dav1d where libdav1d loads. Every
line but the last names the card and its power limit; the last line is
one JSON object. Without a GPU, or run outside a checkout, it exits
non-zero and prints no result.
"""

import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
W, H = 1920, 1080
PAD_H = 1088            # H padded to the 64-px superblock grid
CARD = ""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --- decode oracles (worker processes: numpy only, never JAX) -------------

def own_decode(tus, recons):
    """Decode the TUs with the in-repo decoder; returns the number of
    shown frames and the indices that differ from recons."""
    import numpy as np

    from svt_av1_psy_tpu.decoder.driver import Decoder

    d = Decoder()
    for tu in tus:
        d.decode_temporal_unit(tu)
    bad = [i for i, (f, r) in enumerate(zip(d.frames, recons))
           if not all(np.array_equal(a, b) for a, b in zip((f.y, f.u, f.v),
                                                              r))]
    return len(d.frames), bad


def own_decode_key(seq_tu, tu, recon):
    """One all-intra frame: the sequence header from seq_tu, then tu."""
    import numpy as np

    from svt_av1_psy_tpu.bitstream.obu import ObuType, parse_obus
    from svt_av1_psy_tpu.decoder.driver import Decoder
    from svt_av1_psy_tpu.decoder.header_parser import parse_sequence_header

    d = Decoder()
    for t, _, _, p in parse_obus(seq_tu):
        if t == ObuType.SEQUENCE_HEADER:
            d.seq = parse_sequence_header(p)
    d.decode_temporal_unit(tu)
    f = d.frames[0]
    return all(np.array_equal(a, b) for a, b in zip((f.y, f.u, f.v), recon))


def dav1d_check(tus, recons):
    """dav1d decode against recons; None where libdav1d does not load."""
    import numpy as np
    try:
        from svt_av1_psy_tpu.decoder.dav1d import decode_obus
        frames = decode_obus(b"".join(tus))
    except OSError:
        return None
    check(len(frames) == len(recons),
          f"dav1d decoded {len(frames)} frames, expected {len(recons)}")
    return all(np.array_equal(a, b) for f, r in zip(frames, recons)
               for a, b in zip((f.y, f.u, f.v), r))


# --- phases ---------------------------------------------------------------

class CompileClock:
    """Seconds JAX spends compiling (or loading from the compile cache),
    from its own backend-compile events."""

    def __init__(self):
        from jax import monitoring
        self.total = 0.0

        def listen(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.total += duration
        monitoring.register_event_duration_secs_listener(listen)


def phase_programs(gpu, cpu):
    import jax
    import numpy as np

    from svt_av1_psy_tpu.models.fast_intra import _jitted_gop_search_tf
    from svt_av1_psy_tpu.utils import parity

    t_phase = time.perf_counter()
    for r in parity.check_all(gpu, cpu, PAD_H, W):
        say("phase 2: " + json.dumps(r))
    T = 5
    sds = jax.ShapeDtypeStruct
    ch = (T, PAD_H // 2, W // 2)
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    # M = 32 is the north star's own mini-GoP (5 levels: 2^5 frames)
    for M in (16, 32):
        t0 = time.perf_counter()
        with jax.default_device(gpu):
            comp = _jitted_gop_search_tf().lower(
                sds((M + 1, PAD_H, W), np.uint8),
                sds((3 * M, 2), np.int32), sds((), np.int32),
                sds(ch, np.uint8), sds(ch, np.uint8), sds((T,), np.int32),
                sds((T,), np.float32), sds((), np.float32), 8, 8,
                sds(ch, np.uint8), sds(ch, np.uint8), sds((T,), np.int32),
                sds((T,), np.float32)).compile()
        ma = comp.memory_analysis()
        say(f"phase 2: gop_search_tf M={M} ({M + 1} frames, {3 * M} "
            f"edges) compiled in {time.perf_counter() - t0:.1f} s on this "
            "card; memory_analysis " +
            json.dumps({k: getattr(ma, k, None) for k in keys}))
    say(f"phase 2: {time.perf_counter() - t_phase:.1f} s (compiles and "
        "runs on both devices)")


def make_frames(n, seed=7):
    import numpy as np
    sys.path.insert(0, str(ROOT / "tools"))
    from make_test_clip import make_frame
    rng = np.random.default_rng(seed)
    return [make_frame(W, H, t, 8, 0.02, rng) for t in range(n)]


def phase_northstar(clock, pool):
    import numpy as np

    from svt_av1_psy_tpu.api import Encoder
    from svt_av1_psy_tpu.config import EncoderConfig

    frames = make_frames(33)
    cfg = EncoderConfig(enc_mode=6, qp=30, intra_period_length=-1,
                        hierarchical_levels=5, tf_strength=1,
                        enable_tpl_la=1)
    c0 = clock.total
    t0 = time.perf_counter()
    enc = Encoder(cfg, W, H, bit_depth=8)
    check(enc._ra is not None and enc._enc.enable_lr,
          "north-star config must run RA with LR on")
    pkts, first = [], None
    for f in frames:
        pkts += enc.send_picture(*f)
        if pkts and first is None:
            first = time.perf_counter() - t0
    pkts += enc.flush()
    dt = time.perf_counter() - t0
    first = dt if first is None else first
    enc.close()
    shown = sorted((p for p in pkts if p.display_idx >= 0),
                   key=lambda p: p.display_idx)
    check([p.display_idx for p in shown] == list(range(33)),
          f"north star showed {len(shown)} of 33 frames")
    nbytes = sum(len(p.payload) for p in pkts)
    say(f"phase 3: north star {W}x{H} p6 CRF30 RA, 33 frames, measured on "
        f"this card: {33 / dt:.3f} fps (wall incl. compile), "
        f"{nbytes / 33:.0f} bytes/frame, "
        f"first GoP latency {first:.1f} s (first send_picture to first "
        f"packets), compile {clock.total - c0:.1f} s, wall {dt:.1f} s")
    tus = [p.payload for p in pkts]
    recons = [tuple(np.asarray(x) for x in p.recon) for p in shown]
    return tus, recons, pool.apply_async(own_decode, (tus, recons))


def phase_allintra(clock, pool):
    from svt_av1_psy_tpu.api import Encoder
    from svt_av1_psy_tpu.config import EncoderConfig

    frames = make_frames(8, seed=11)
    cfg = EncoderConfig(enc_mode=12, qp=35, intra_period_length=0)
    c0 = clock.total
    t0 = time.perf_counter()
    enc = Encoder(cfg, W, H, bit_depth=8)
    outs = [enc.encode(*f) for f in frames]
    dt = time.perf_counter() - t0
    enc.close()
    nbytes = sum(len(o.payload) for o in outs)
    say(f"phase 4: preset 12 all-intra {W}x{H}, 8 frames, measured on this "
        f"card (host shared with one decode worker): {8 / dt:.3f} fps "
        f"(wall incl. compile), "
        f"{nbytes / 8:.0f} bytes/frame, compile {clock.total - c0:.1f} s, "
        f"wall {dt:.1f} s")
    tus = [o.payload for o in outs]
    recons = [(o.recon_y, o.recon_u, o.recon_v) for o in outs]
    jobs = [pool.apply_async(own_decode_key, (tus[0], tu, r))
            for tu, r in zip(tus, recons)]
    return tus, recons, jobs


def phase_cli(tmp):
    from svt_av1_psy_tpu.app.cli import main
    from svt_av1_psy_tpu.decoder.dav1d import decode_ivf
    from svt_av1_psy_tpu.io.y4m import Y4mWriter

    clip = tmp / "clip.y4m"
    with Y4mWriter(str(clip), W, H) as wr:
        for f in make_frames(8, seed=13):
            wr.write_frame(*f)
    base = ["--preset", "8", "--progress", "0"]
    one = tmp / "one.ivf"
    t0 = time.perf_counter()
    check(main(["-i", str(clip), "-b", str(one)] + base) == 0,
          "CLI encode failed")
    t1 = time.perf_counter()
    a, b = tmp / "a.ivf", tmp / "b.ivf"
    check(main(["--nch", "2", "-i", f"{clip},{clip}", "-b", f"{a},{b}"]
               + base) == 0, "CLI --nch 2 failed")
    t2 = time.perf_counter()
    check(a.read_bytes() == b.read_bytes() == one.read_bytes(),
          "--nch 2 channels differ from each other or from one channel")
    try:
        n = len(decode_ivf(str(one)))
    except OSError:
        n = None
    check(n in (None, 8), f"dav1d decoded {n} of 8 CLI frames")
    say(f"phase 5: CLI p8 {W}x{H} 8 frames: one channel {t1 - t0:.1f} s, "
        f"--nch 2 in one process {t2 - t1:.1f} s, identical streams, "
        f"dav1d frames {n if n is not None else 'not run'}")


def phase_gpu_tests():
    import contextlib
    import io

    import pytest

    # the card-only tests compare the GPU with the CPU device
    os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                          str(ROOT / "tests")])
    for line in out.getvalue().splitlines():
        say("phase 6: " + line)
    check(rc == 0, f"pytest -m gpu exited {int(rc)}")


def run_phases(clock, dev, cpu):
    """Phases 2-6 on dev, with cpu as the reference device. Phase 3 runs
    first: the in-repo decode of its stream is the longest check, and it
    then overlaps the other phases."""
    import multiprocessing
    import tempfile

    workers = max(2, min(9, (os.cpu_count() or 4) // 2))
    # a spawn pool: the decode workers never touch JAX or the card, and
    # leaving the block (or failing inside it) terminates them
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        ns_tus, ns_rec, ns_job = phase_northstar(clock, pool)
        phase_programs(dev, cpu)
        ai_tus, ai_rec, ai_jobs = phase_allintra(clock, pool)
        for name, tus, rec in (("north star", ns_tus, ns_rec),
                               ("all-intra", ai_tus, ai_rec)):
            ok = dav1d_check(tus, rec)
            check(ok is not False, f"{name}: dav1d decode != recon")
            say(f"phases 3-4: {name} dav1d "
                f"{'bit-exact' if ok else 'not loaded'}")
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(pathlib.Path(tmp))
        phase_gpu_tests()
        t0 = time.perf_counter()
        n, bad = ns_job.get()
        check(n == 33 and not bad,
              f"north star in-repo decode: {n} frames, mismatches {bad}")
        check(all(j.get() for j in ai_jobs),
              "all-intra in-repo decode != recon")
        say(f"phases 3-4: in-repo decoder bit-exact on both streams "
            f"(waited {time.perf_counter() - t0:.1f} s for it)")
        pool.close()
        pool.join()


def main() -> int:
    global CARD
    if not (ROOT / "svt_av1_psy_tpu").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import jax

    from svt_av1_psy_tpu.utils.device import (configure_compile_cache,
                                              gpu_name_and_power_limit,
                                              select_platform)
    try:
        select_platform("gpu")
    except RuntimeError as e:
        fail(str(e))
    devs = jax.devices()
    CARD = gpu_name_and_power_limit() or ""
    check(bool(CARD), "nvidia-smi gave no card name and power limit")
    cache = configure_compile_cache()
    clock = CompileClock()
    t_start = time.perf_counter()
    say(f"card: {CARD}")
    say(f"phase 1: platform {devs[0].platform}, device_kind "
        f"{devs[0].device_kind}, count {len(devs)}, compile cache {cache}")

    run_phases(clock, devs[0], jax.devices("cpu")[0])
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
