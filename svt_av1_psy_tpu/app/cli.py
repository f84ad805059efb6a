"""Command-line encoder app (SvtAv1EncApp equivalent).

Usage:
    python -m svt_av1_psy_tpu -i in.y4m -b out.ivf [--preset 12] [--crf 35]
        [--gop 0|1|N] [--frames N]

Encodes 4:2:0 y4m to an AV1 IVF stream: device search programs (JAX)
feed native C commit walks on the host.
Preset routing (the enc_mode_config.c role, at current feature scope):
  preset >= 10 : fast path — dense device mode search + native C commit
                 walk (models/fast_intra.py)
  preset <=  9 : quality path — full per-block RD funnel
                 (models/intra_encoder.py)
Mirrors the reference app's role (ref Source/App/app_main.c:494).
"""
from __future__ import annotations

import argparse
import sys
import time


def _progress(mode: int, n: int, total: int, nbytes: int, t0: float,
              fps_hint: float) -> None:
    """Per-frame progress line (ref app_process_cmd.c:962-1025; mode 3
    is the PSY progress with fps/bitrate/ETA/projected size)."""
    if mode == 0 or n == 0:
        return
    dt = max(time.time() - t0, 1e-6)
    fps = n / dt
    if mode == 1:
        print(f"\rEncoding frame {n}", end="", file=sys.stderr)
        return
    kbps = nbytes * 8 * fps_hint / n / 1000.0
    if mode == 2:
        print(f"\rEncoding frame {n}  {fps:.2f} fps  {kbps:.1f} kbps",
              end="", file=sys.stderr)
        return
    if total:
        eta = (total - n) / fps
        proj = nbytes / n * total / 1e6
        print(f"\rEncoding frame {n}/{total}  {fps:.2f} fps  "
              f"{kbps:.1f} kbps  ETA {eta:.0f}s  ~{proj:.2f} MB",
              end="", file=sys.stderr)
    else:
        print(f"\rEncoding frame {n}  {fps:.2f} fps  {kbps:.1f} kbps  "
              f"{nbytes / 1e6:.2f} MB", end="", file=sys.stderr)


def crf_to_qindex(crf: float) -> int:
    """CRF -> base qindex. The reference's extended CRF maps crf to
    qindex = crf*4 with quarter-step offsets (ref enc_settings.c:1128
    get_extended_crf); integer CRFs map exactly to crf*4."""
    return max(0, min(255, int(round(crf * 4))))


def _run_ra(args, reader, enc, t0, rc=None) -> int:
    """Random-access encode loop: display-order sources in, decode-order
    packets out (hidden anchors + show_existing_frame TUs). The IVF
    carries one frame per temporal unit in decode order (the
    packetization_process.c emission order). Rate control applies at
    GoP granularity (base q adjusted between mini-GoPs; no recode —
    the reference also disables recode at fast presets)."""
    import math

    import numpy as np

    from svt_av1_psy_tpu.bitstream.ivf import IvfWriter

    W, H = reader.header.width, reader.header.height
    ivf = IvfWriter(args.output, W, H)
    peak = float((1 << reader.header.bit_depth) - 1) ** 2
    sources = {}
    stats = []
    total_bytes = 0
    npkt = 0
    nshown = 0

    def psnr(a, b):
        m = float(np.mean((np.asarray(a, np.float64) -
                           np.asarray(b, np.float64)) ** 2))
        return 10 * math.log10(peak / max(m, 1e-9))

    def handle(p):
        nonlocal total_bytes, npkt, nshown
        ivf.write_frame(p.payload, npkt)
        total_bytes += len(p.payload)
        if rc is not None and len(p.payload) > 32:
            rc.update(enc._enc.qindex, 8 * len(p.payload),
                      is_key=(npkt == 0))
        npkt += 1
        if p.display_idx >= 0:
            nshown += 1
            if not args.enable_stat_report:
                _progress(args.progress, nshown, args.frames, total_bytes,
                          t0, args.fps)
            if args.enable_stat_report and p.display_idx in sources:
                from svt_av1_psy_tpu.ops.metrics import ssim_plane
                sy, su, sv = sources.pop(p.display_idx)
                ry, ru, rv = p.recon
                bd = reader.header.bit_depth
                stats.append((p.display_idx, len(p.payload),
                              psnr(sy, ry), psnr(su, ru), psnr(sv, rv),
                              ssim_plane(sy, ry, bd=bd)))
                print(f"frame {p.display_idx}: {len(p.payload):7d} B  "
                      f"PSNR Y {stats[-1][2]:.2f}  U {stats[-1][3]:.2f}  "
                      f"V {stats[-1][4]:.2f}  SSIM {stats[-1][5]:.4f}",
                      file=sys.stderr)

    src_count = 0
    for (y, u, v) in reader:
        if args.frames and src_count >= args.frames:
            break
        if args.enable_stat_report:
            sources[src_count] = (y, u, v)
        src_count += 1
        if rc is not None:
            enc._enc.qindex = rc.frame_qindex(is_key=False)
        for p in enc.send_picture(y, u, v):
            handle(p)
    for p in enc.flush():
        handle(p)
    enc.close()
    ivf.close()
    if args.progress and nshown and not args.enable_stat_report:
        print(file=sys.stderr)
    dt = time.time() - t0
    if nshown:
        print(f"encoded {nshown} frames, {total_bytes} bytes, "
              f"{dt:.2f}s ({nshown / dt:.3f} fps)", file=sys.stderr)
        if args.enable_stat_report and stats:
            avg = [sum(s[i] for s in stats) / len(stats)
                   for i in (2, 3, 4, 5)]
            kbps = total_bytes * 8 * args.fps / nshown / 1000
            print(f"SUMMARY: {kbps:.1f} kbps  avg PSNR "
                  f"Y {avg[0]:.2f}  U {avg[1]:.2f}  V {avg[2]:.2f}  "
                  f"SSIM {avg[3]:.4f}", file=sys.stderr)
            if args.stat_file:
                with open(args.stat_file, "w") as sf:
                    sf.write("frame,bytes,psnr_y,psnr_u,psnr_v,ssim_y\n")
                    for s2 in sorted(stats):
                        sf.write(",".join(str(x) for x in s2) + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svt_av1_psy_tpu")
    ap.add_argument("-i", "--input", required=True, help="input .y4m")
    ap.add_argument("-b", "--output", required=True, help="output .ivf")
    ap.add_argument("--preset", type=int, default=8,
                    help="encoder preset -1..13 (higher = faster); "
                         ">=10 uses the device-search fast path")
    ap.add_argument("--crf", type=float, default=None,
                    help="constant rate factor 1..70 (4*crf = qindex)")
    ap.add_argument("-q", "--qindex", type=int, default=None,
                    help="base qindex 0..255 (overrides --crf)")
    ap.add_argument("--keyint", "--gop", dest="gop", type=int, default=-2,
                    help="-2 = auto (~5s of video, the reference default: "
                         "random-access GoPs), 1 = all intra, 0 = IPPP "
                         "low delay, N = key frame every N frames")
    ap.add_argument("-n", "--frames", type=int, default=0,
                    help="max frames to encode (0 = all)")
    ap.add_argument("--min-block", type=int, default=8)
    ap.add_argument("--tile-columns", type=int, default=-1,
                    help="log2 tile columns (-1 = auto)")
    ap.add_argument("--tile-rows", type=int, default=-1,
                    help="log2 tile rows (-1 = none)")
    ap.add_argument("--no-device-search", action="store_true",
                    help="disable the device open-loop mode search stage")
    ap.add_argument("--device", default=None, choices=("gpu", "cpu"),
                    help="platform of the device search programs: gpu "
                         "(the default unless JAX_PLATFORMS names cpu) "
                         "or cpu. A platform without a device is an "
                         "error; there is no fallback")
    ap.add_argument("--backend", default="native",
                    choices=("native", "python"))
    ap.add_argument("--rc", type=int, default=0, choices=(0, 1, 2),
                    help="rate control mode: 0 = CRF/CQP, 1 = VBR, "
                         "2 = CBR (ref rc_process.c:3269)")
    ap.add_argument("--tbr", "--bitrate", dest="bitrate", type=float,
                    default=0.0,
                    help="target bitrate in kbps (VBR/CBR, or 2-pass)")
    ap.add_argument("--mbr", type=float, default=0.0,
                    help="max bitrate kbps: capped CRF when --rc 0 "
                         "(the --mbr analog), peak rate for CBR")
    ap.add_argument("--undershoot-pct", type=int, default=25)
    ap.add_argument("--overshoot-pct", type=int, default=25)
    ap.add_argument("--buf-sz", type=int, default=1000,
                    help="CBR buffer size in ms")
    ap.add_argument("--recode", type=int, default=1, choices=(0, 1),
                    help="re-encode frames that violate rate limits")
    ap.add_argument("--pass", dest="pass_num", type=int, default=0,
                    choices=(0, 1, 2),
                    help="multi-pass: 1 collects stats, 2 allocates "
                         "from them (ref pass2_strategy.c)")
    ap.add_argument("--stats", default="svtav1_2pass.log",
                    help="2-pass stats file path")
    ap.add_argument("--qpfile", default=None,
                    help="per-frame qindex overrides: lines of "
                         "'<frame> <qindex>' applied on the fly (the "
                         "--qpfile analog, ref app_process_cmd.c:551)")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--enable-variance-boost", type=int, default=0,
                    choices=(0, 1),
                    help="variance-boost AQ: per-SB delta-q from source "
                         "variance (PSY flagship feature)")
    ap.add_argument("--variance-boost-strength", type=int, default=2,
                    choices=(1, 2, 3, 4))
    ap.add_argument("--sharpness", type=int, default=0,
                    help="PSY sharpness -7..7: quant rounding bias that "
                         "retains high-frequency energy")
    ap.add_argument("--frame-luma-bias", type=int, default=0,
                    help="PSY frame-luma-bias 0..100: lower q for dark "
                         "frames")
    ap.add_argument("--enable-stat-report", action="store_true",
                    help="per-frame PSNR report + end summary (the "
                         "--enable-stat-report / svt_psnr.c analog)")
    ap.add_argument("--stat-file", default=None,
                    help="write the per-frame stats to a file")
    ap.add_argument("--enable-tf", type=int, default=1, choices=(0, 1, 2),
                    help="alt-ref temporal filtering: 0 off, 1 on, "
                         "2 adaptive (skips TF on high-motion windows; "
                         "the reference's EnableTF semantics)")
    ap.add_argument("--tf-strength", type=int, default=1,
                    help="PSY tf-strength 0..4 (4x weaker scaling than "
                         "mainline)")
    ap.add_argument("--enable-tpl", type=int, default=1,
                    help="1 = TPL lookahead AQ (default 1 like the "
                         "reference): per-SB qindex offsets / RA r0-beta "
                         "per-frame q from temporal dependency "
                         "propagation (the enable-tpl-la analog)")
    ap.add_argument("--psy-rd", type=float, default=0.0,
                    help="PSY psy-rd 0..6: energy-preservation RD bias")
    ap.add_argument("--film-grain", type=int, default=0,
                    help="1 = estimate AR grain from the source and signal "
                         "it for decoder-side synthesis (PSY adaptive "
                         "block size)")
    ap.add_argument("--fgs-table", default=None,
                    help="external film-grain table file (aom "
                         "'filmgrn1' text format; ref --fgs-table, "
                         "app_config.c:2654)")
    ap.add_argument("--variance-octile", type=int, default=6,
                    choices=range(1, 9))
    ap.add_argument("--enable-restoration", type=int, default=-1,
                    choices=(-1, 0, 1),
                    help="loop restoration (Wiener): -1 = preset default "
                         "(off at fast presets, the M10+ derivation), "
                         "1 = on (cross-frame param cache in the fast "
                         "path)")
    ap.add_argument("--hierarchical-levels", type=int, default=-1,
                    choices=(-1, 0, 2, 3, 4, 5),
                    help="pyramid levels (-1 = auto: 5 at presets <= 12 "
                         "for periodic-keyint random access, matching the "
                         "reference's preset derivation; 0 = flat). With "
                         "--pred-struct 2 and --keyint > 1 this enables "
                         "the random-access mini-GoP pyramid (hidden "
                         "anchors + show_existing_frame)")
    ap.add_argument("--pred-struct", type=int, default=2, choices=(1, 2),
                    help="1 = low delay, 2 = random access (the "
                         "SVT_AV1_PRED_* enum)")
    ap.add_argument("--content-light", default=None,
                    help="HDR CLL metadata 'maxcll,maxfall' (nits), "
                         "emitted as a metadata OBU on key frames")
    ap.add_argument("--mastering-display", default=None,
                    help="HDR MDCV metadata "
                         "'G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)' "
                         "(the reference CLI string format)")
    ap.add_argument("--dolby-vision-rpu", type=str, default=None,
                    help="per-frame T.35 metadata file (the DoVi RPU "
                         "attach surface, ref app_process_cmd.c:463): "
                         "binary records of [u32le length][payload], one "
                         "per display frame, each wrapped as an ITU-T "
                         "T.35 metadata OBU on its frame (no libdovi in "
                         "this image, so raw payloads attach as-is)")
    ap.add_argument("--t35-file", default=None,
                    help="binary ITU-T T.35 blob (DoVi RPU / HDR10+ "
                         "container) injected as a per-frame metadata "
                         "OBU (ref app_process_cmd.c:463-495)")
    ap.add_argument("-c", "--config", default=None,
                    help="config file: one CLI token per line "
                         "('crf 35' or '--crf 35'; # comments), same "
                         "token set as the command line (the reference "
                         "app's config-file layer, ref app_config.c)")
    ap.add_argument("--progress", type=int, default=1, choices=(0, 1, 2, 3),
                    help="0 none, 1 frame count, 2 single-line rate, "
                         "3 ETA/size/fps (PSY progress-3; ref "
                         "app_process_cmd.c:962)")
    ap.add_argument("--nch", type=int, default=1,
                    help="number of channels: comma-separate -i/-b "
                         "(and optionally --crf) to encode N streams "
                         "concurrently, one encoder per thread in this "
                         "process, all sharing one device "
                         "(ref app_main.c:153)")
    ap.add_argument("--superres-mode", type=int, default=0,
                    choices=(0, 1),
                    help="super-resolution: 1 codes frames at the "
                         "downscaled width and signals the normative "
                         "upscale (all-intra; ref --superres-mode)")
    ap.add_argument("--superres-denom", type=int, default=16,
                    help="superres denominator 9..16 (width scales by "
                         "8/denom; ref --superres-denom)")
    ap.add_argument("--scm", type=int, default=2, choices=(0, 1, 2),
                    help="screen content tools: 0 off, 1 on (palette + "
                         "intra block copy, routes to the full RD path), "
                         "2 content-based detection (ref --scm)")
    ap.add_argument("--svtav1-params", default=None,
                    help="colon-separated key=value parameter string "
                         "(the svt_av1_enc_parse_parameter surface, "
                         "ref EbSvtAv1Enc.h:1143)")
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    # config file (ref app_config.c read_config_file): one token pair per
    # line, '#' comments; file tokens come first so the CLI overrides
    if "-c" in argv or "--config" in argv:
        ci = argv.index("-c") if "-c" in argv else argv.index("--config")
        cfg_path = argv[ci + 1]
        extra = []
        with open(cfg_path) as cf:
            for line in cf:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                tok, _, val = line.partition(" ")
                if not tok.startswith("-"):
                    tok = "--" + tok.lstrip("-")
                extra.append(tok)
                if val.strip():
                    extra.append(val.strip())
        argv = extra + argv
    args = ap.parse_args(argv)

    # multi-channel (--nch; ref app_main.c:153-169): comma-separated
    # -i/-b run as independent encoder instances on threads of this
    # process (one JAX process per device: a second process would find
    # the device memory already reserved)
    if args.nch > 1:
        inputs = args.input.split(",")
        outputs = args.output.split(",")
        assert len(inputs) == len(outputs) == args.nch, \
            "--nch N needs N comma-separated -i and -b values"
        import threading
        import traceback
        rcs = [1] * args.nch

        def channel(k, sub):
            try:
                rcs[k] = main(sub)
            except Exception:
                traceback.print_exc()

        threads = []
        for k in range(args.nch):
            sub = list(argv)

            def repl(flag_names, value):
                for fn2 in flag_names:
                    if fn2 in sub:
                        sub[sub.index(fn2) + 1] = value
            repl(("-i", "--input"), inputs[k])
            repl(("-b", "--output"), outputs[k])
            i2 = sub.index("--nch")
            del sub[i2:i2 + 2]
            threads.append(threading.Thread(target=channel, args=(k, sub)))
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return max(rcs)

    if args.qindex is None:
        args.qindex = crf_to_qindex(args.crf) if args.crf is not None \
            else 100

    if not args.no_device_search:
        from svt_av1_psy_tpu.utils.device import select_platform
        try:
            select_platform(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from svt_av1_psy_tpu.bitstream.ivf import IvfWriter
    from svt_av1_psy_tpu.io.y4m import Y4mReader

    t0 = time.time()
    n = 0
    total_bytes = 0

    def is_key(idx):
        if args.gop == 1:
            return True
        if args.gop == 0:
            return idx == 0
        return idx % args.gop == 0

    with Y4mReader(args.input) as reader:
        W = reader.header.width
        H = reader.header.height
        bd = reader.header.bit_depth
        # auto keyint: ~5 seconds of video (the reference's default
        # intra-period -2, ref pd_process.c keyint derivation)
        if args.gop == -2:
            fpsv = reader.header.fps_num / max(reader.header.fps_den, 1)
            args.gop = max(1, int(round(fpsv * 5)))
        # auto pyramid depth (the reference's preset derivation,
        # ref set_param_based_on_input: 5 levels through M12): periodic
        # keyint + random access = the mini-GoP pyramid by default
        if args.hierarchical_levels == -1:
            args.hierarchical_levels = (5 if args.preset <= 12 else 4) \
                if (args.pred_struct == 2 and args.gop > 1) else 0
        from svt_av1_psy_tpu.api import Encoder
        from svt_av1_psy_tpu.config import (EncoderConfig,
                                            parse_parameter_string)
        cfg = EncoderConfig(
            enc_mode=args.preset,
            qp=args.qindex // 4,
            intra_period_length=(0 if args.gop == 1 else
                                 -1 if args.gop == 0 else
                                 args.gop - 1),
            enable_variance_boost=bool(args.enable_variance_boost),
            variance_boost_strength=args.variance_boost_strength,
            variance_octile=args.variance_octile,
            tile_columns=(args.tile_columns if args.tile_columns >= 0
                          else -1),
            tile_rows=args.tile_rows if args.tile_rows >= 0 else -1,
            sharpness=args.sharpness,
            frame_luma_bias=args.frame_luma_bias,
            film_grain_denoise_strength=args.film_grain,
            enable_restoration_filtering=args.enable_restoration,
            hierarchical_levels=args.hierarchical_levels,
            pred_structure=args.pred_struct,
            enable_tf=args.enable_tf,
            tf_strength=(args.tf_strength if args.enable_tf else 0),
            enable_tpl_la=args.enable_tpl,
            psy_rd=args.psy_rd,
            screen_content_mode=args.scm,
            superres_mode=args.superres_mode,
            superres_denom=args.superres_denom,
            tune=2 if args.psy_rd else 2)
        if args.svtav1_params:
            cfg = parse_parameter_string(cfg, args.svtav1_params)
        enc = Encoder(cfg, W, H, bit_depth=bd)
        enc._enc.qindex = args.qindex   # qindex-level precision
        if args.fgs_table:
            from svt_av1_psy_tpu.models.film_grain import load_fgs_table
            enc._enc.film_grain = load_fgs_table(args.fgs_table)

        # --- HDR / T.35 metadata OBUs (ref metadata_handle.c) ---
        if args.content_light or args.mastering_display or args.t35_file:
            from svt_av1_psy_tpu.bitstream.metadata import \
                build_metadata_payload
            enc._enc.metadata_key = build_metadata_payload(
                content_light=args.content_light,
                mastering_display=args.mastering_display)
            if args.t35_file:
                with open(args.t35_file, "rb") as tf:
                    enc._enc.metadata_frame = build_metadata_payload(
                        t35_blob=tf.read())
        if args.dolby_vision_rpu:
            from svt_av1_psy_tpu.bitstream.metadata import \
                build_metadata_payload
            per = {}
            with open(args.dolby_vision_rpu, "rb") as rf:
                idx = 0
                while True:
                    hdr = rf.read(4)
                    if len(hdr) < 4:
                        break
                    ln = int.from_bytes(hdr, "little")
                    payload = rf.read(ln)
                    if len(payload) < ln:
                        break
                    # keyed by TRUE display index (order hints wrap at
                    # 128; a masked key would misattach payloads on any
                    # stream longer than 128 frames)
                    per[idx] = build_metadata_payload(
                        t35_blob=payload)
                    idx += 1
            enc._enc.metadata_per_frame = per

        # --- rate control setup (ref rc_process.c; pass2_strategy.c) ---
        rc = None
        twopass = None
        fp_stats = None
        qp_overrides = {}
        if args.qpfile:
            with open(args.qpfile) as qf:
                for line in qf:
                    parts = line.split()
                    if len(parts) >= 2 and not parts[0].startswith("#"):
                        qp_overrides[int(parts[0])] = int(parts[1])
        from svt_av1_psy_tpu.models.ratecontrol import (FirstPassStats,
                                                        RateController,
                                                        TwoPassAllocator)
        if args.pass_num == 1:
            fp_stats = FirstPassStats()
        elif args.pass_num == 2:
            twopass = TwoPassAllocator(FirstPassStats.load(args.stats),
                                       target_bps=args.bitrate * 1000,
                                       fps=args.fps, bd=bd)
        elif args.rc in (1, 2) or args.mbr > 0:
            rc = RateController(
                mode=("vbr" if args.rc == 1 else
                      "cbr" if args.rc == 2 else "crf"),
                base_qindex=args.qindex,
                target_bps=args.bitrate * 1000, max_bps=args.mbr * 1000,
                fps=args.fps, bd=bd, buf_size_ms=args.buf_sz,
                undershoot_pct=args.undershoot_pct,
                overshoot_pct=args.overshoot_pct,
                gop_size=args.gop, recode=bool(args.recode))

        if enc._ra is not None:
            return _run_ra(args, reader, enc, t0, rc=rc)
        ivf = None
        pending = []       # lookahead buffer [(idx, (y,u,v))]
        history = []       # last 2 source frames (TF window)
        src_idx = 0

        def frames_iter():
            """Source frames with key-frame temporal filtering applied
            (ref temporal_filtering.c; 2-frame lookahead window)."""
            nonlocal src_idx
            # >=1 frame of lookahead so the device decide for frame N+1
            # can overlap frame N's host commit walk (prefetch_decide)
            look = max(2 if args.enable_tf else 0,
                       3 if args.enable_tpl else 0, 1)
            for f in reader:
                pending.append(f)
                if args.frames and src_idx + len(pending) > args.frames                         and len(pending) > 1:
                    pending.pop()
                    continue
                while len(pending) > look:
                    cur = pending.pop(0)
                    if args.enable_tf and is_key(src_idx):
                        from svt_av1_psy_tpu.models.temporal_filter import                             temporal_filter
                        win = history[-2:] + [cur] + pending[:2]
                        cur = temporal_filter(win, len(history[-2:]),
                                              strength=args.tf_strength)
                    history.append(cur if not args.enable_tf else
                                   (pending[0] if pending else cur))
                    if len(history) > 2:
                        history.pop(0)
                    yield cur, [p[0] for p in pending[:3]]
                    src_idx += 1
            while pending:
                cur = pending.pop(0)
                if args.enable_tf and is_key(src_idx):
                    from svt_av1_psy_tpu.models.temporal_filter import                         temporal_filter
                    win = history[-2:] + [cur] + pending[:2]
                    cur = temporal_filter(win, len(history[-2:]),
                                          strength=args.tf_strength)
                history.append(cur)
                if len(history) > 2:
                    history.pop(0)
                yield cur, [p[0] for p in pending[:3]]
                src_idx += 1

        stats = []
        for (y, u, v), la_frames in frames_iter():
            if ivf is None:
                ivf = IvfWriter(args.output, W, H)
            if args.enable_tpl:
                from svt_av1_psy_tpu.models.tpl import tpl_sb_offsets
                enc._enc.tpl_offsets = tpl_sb_offsets(y, la_frames)
            # per-frame q from qpfile / pass-2 allocation / one-pass RC
            key = is_key(n)
            q = None
            if n in qp_overrides:
                q = qp_overrides[n]
            elif twopass is not None:
                q = twopass.frame_qindex(n)
            elif rc is not None:
                q = rc.frame_qindex(key)
            if q is not None:
                enc._enc.qindex = max(1, min(255, q))
            can_recode = (rc is not None and rc.recode and
                          hasattr(enc._enc, "snapshot"))
            snap = enc._enc.snapshot() if can_recode else None
            if la_frames and hasattr(enc._enc, "prefetch_decide"):
                enc._enc.prefetch_decide(la_frames[0])
            f = enc.encode(y, u, v)
            if can_recode:
                # recode loop (ref rc_process.c:3269): re-encode when the
                # frame size violates the buffer/overshoot constraints
                attempt = 0
                while True:
                    nq = rc.recode_qindex(enc._enc.qindex,
                                          8 * len(f.payload), key,
                                          attempt=attempt)
                    if nq is None:
                        break
                    enc._enc.restore(snap)
                    enc._enc.qindex = nq
                    f = enc.encode(y, u, v)
                    attempt += 1
            if rc is not None:
                rc.update(enc._enc.qindex, 8 * len(f.payload), key)
            if twopass is not None:
                twopass.update(n, 8 * len(f.payload))
            if fp_stats is not None:
                fp_stats.add(n, enc._enc.qindex, 8 * len(f.payload), key)
            ivf.write_frame(f.payload, n)
            total_bytes += len(f.payload)
            if args.enable_stat_report:
                import math

                import numpy as np
                peak = float((1 << reader.header.bit_depth) - 1) ** 2

                def psnr(a, b):
                    m = float(np.mean((np.asarray(a, np.float64) -
                                       np.asarray(b, np.float64)) ** 2))
                    return 10 * math.log10(peak / max(m, 1e-9))

                from svt_av1_psy_tpu.ops.metrics import ssim_plane
                stats.append((n, len(f.payload), psnr(y, f.recon_y),
                              psnr(u, f.recon_u), psnr(v, f.recon_v),
                              ssim_plane(y, f.recon_y,
                                         bd=reader.header.bit_depth)))
                print(f"frame {n}: {len(f.payload):7d} B  "
                      f"PSNR Y {stats[-1][2]:.2f}  U {stats[-1][3]:.2f}  "
                      f"V {stats[-1][4]:.2f}  SSIM {stats[-1][5]:.4f}",
                      file=sys.stderr)
            n += 1
            _progress(args.progress, n, args.frames, total_bytes, t0,
                      args.fps)
            if args.frames and n >= args.frames:
                break
        if args.progress and n:
            print(file=sys.stderr)
        # drain deferred filter threads before teardown (all-intra
        # pipelining defers DLF/CDEF apply off the critical path)
        enc.close()
        if ivf is not None:
            ivf.close()
        if fp_stats is not None:
            fp_stats.dump(args.stats)
            print(f"pass 1: wrote {len(fp_stats.frames)} frame stats to "
                  f"{args.stats}", file=sys.stderr)
    dt = time.time() - t0
    if n:
        print(f"encoded {n} frames, {total_bytes} bytes, "
              f"{dt:.2f}s ({n / dt:.3f} fps)", file=sys.stderr)
        if args.enable_stat_report and stats:
            avg = [sum(s[i] for s in stats) / len(stats)
                   for i in (2, 3, 4, 5)]
            kbps = total_bytes * 8 * args.fps / n / 1000
            print(f"SUMMARY: {kbps:.1f} kbps  avg PSNR "
                  f"Y {avg[0]:.2f}  U {avg[1]:.2f}  V {avg[2]:.2f}  "
                  f"SSIM {avg[3]:.4f}", file=sys.stderr)
            if args.stat_file:
                with open(args.stat_file, "w") as sf:
                    sf.write("frame,bytes,psnr_y,psnr_u,psnr_v,ssim_y\n")
                    for s2 in stats:
                        sf.write(",".join(str(x) for x in s2) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
