"""Public encoder API: the EbSvtAv1Enc.h analog.

Lifecycle mirrors the reference's C API (ref Source/API/EbSvtAv1Enc.h:
svt_av1_enc_init_handle -> set_parameter -> init -> send_picture ->
get_packet -> deinit) collapsed into one idiomatic class driven by the
single EncoderConfig schema (config.py — the EbSvtAv1EncConfiguration
mirror, shared by the CLI flags, key=value parameter strings, and this
API):

    cfg = EncoderConfig(enc_mode=12, qp=35)
    cfg = parse_parameter_string(cfg, "sharpness=2:film-grain=1")
    enc = Encoder(cfg, width=1920, height=1080)
    for (y, u, v) in frames:
        pkt = enc.encode(y, u, v)        # returns an EncodedFrame
    enc.flush()

Preset routing (the enc_mode_config.c role): enc_mode >= 10 runs the
fast two-phase path (device search + native commit walk); lower presets
run the full RD funnel.
"""

from __future__ import annotations

import numpy as np

from svt_av1_psy_tpu.config import (DEFAULT, EncoderConfig, PredStructure,
                                    validate_config)


def _gop_from_cfg(cfg: EncoderConfig) -> int:
    """Map (pred_structure, intra_period) to the encoder gop convention
    (1 = all intra, 0 = open IPPP, N = keyint)."""
    ip = cfg.intra_period_length
    if ip == 0:
        return 1
    if ip == -2:
        # auto keyint: ~5s of video
        return max(1, int(cfg.frame_rate * 5))
    if ip == -1:
        return 0
    return ip + 1


class Encoder:
    """One encode channel (the EbComponentType analog)."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int,
                 bit_depth: int | None = None):
        from svt_av1_psy_tpu.utils.device import configure_compile_cache
        configure_compile_cache()
        cfg = cfg.replace(source_width=width, source_height=height)
        if bit_depth is not None:
            cfg = cfg.replace(encoder_bit_depth=bit_depth)
        self.cfg = validate_config(cfg)
        self.width, self.height = width, height
        self._ra = None
        bd = self.cfg.encoder_bit_depth
        qindex = min(255, int(round(self.cfg.crf * 4)))
        preset = self.cfg.enc_mode
        # presets >= 4 run the two-phase device-search + C-commit path
        # (the production configuration); presets <= 3 keep the full
        # python RD funnel with its extra tools (per-64x64 CDEF search,
        # CfL/filter-intra, segmentation AQ, LR search)
        self._fast = preset >= 4
        # screen content tools live in the full RD path (palette + IBC
        # searches, ref palette.c / hash_motion.c); --scm 1 routes there
        if self.cfg.screen_content_mode == 1:
            self._fast = False
        gop = _gop_from_cfg(self.cfg)
        if self._fast:
            from svt_av1_psy_tpu.models.fast_intra import FastIntraEncoder
            n_cands = {13: 1, 12: 2}.get(preset, 3)
            tc = self.cfg.tile_columns
            # superres (spec 5.9.8): FIXED mode codes every frame at the
            # downscaled width (all-intra only in this encoder)
            sd = 0
            if int(self.cfg.superres_mode) == 1:
                sd = self.cfg.superres_denom
                assert gop == 1, \
                    "superres-mode 1 requires all-intra (intra-period 0)"
            tr = self.cfg.tile_rows
            enc = FastIntraEncoder(
                width, height, qindex=qindex, bd=bd, n_cands=n_cands,
                n_tiles=0 if tc == DEFAULT else max(1, 1 << tc),
                n_tile_rows=0 if tr == DEFAULT else max(1, 1 << tr),
                superres_denom=sd)
            enc.gop_size = gop
            enc.enable_variance_boost = self.cfg.enable_variance_boost
            enc.vb_strength = self.cfg.variance_boost_strength
            enc.vb_octile = self.cfg.variance_octile
            enc.sharpness = self.cfg.sharpness
            enc.frame_luma_bias = self.cfg.frame_luma_bias
            enc.psy_rd = self.cfg.psy_rd
            # PSY noise normalization (auto strength 3 at tune 3;
            # ref full_loop.c:1486-1495)
            nn = self.cfg.noise_norm_strength
            if nn < 1 and int(self.cfg.tune) == 3:
                nn = 3
            enc.noise_norm = nn
            # Tune 3 swaps candidate distortion to the SSIM-weighted
            # kernel (SSIM_LVL_1; ref enc_mode_config.c:7883)
            enc.tune_ssim = int(self.cfg.tune) == 3
            # quantizer matrices (PSY default ON, decoupled chroma range;
            # ref enc_settings.c:1084-1088, md_config_process.c:218)
            if self.cfg.enable_qm:
                enc.qm_cfg = (self.cfg.min_qm_level,
                              self.cfg.max_qm_level,
                              self.cfg.min_chroma_qm_level,
                              self.cfg.max_chroma_qm_level,
                              int(self.cfg.tune))
            if self.cfg.hierarchical_levels and \
                    self.cfg.pred_structure == PredStructure.LOW_DELAY_B:
                enc.hierarchical_levels = min(self.cfg.hierarchical_levels,
                                              3)
                enc.qp_scale_compress_strength = \
                    self.cfg.qp_scale_compress_strength
            elif self.cfg.hierarchical_levels and gop != 1 and \
                    self.cfg.pred_structure == PredStructure.RANDOM_ACCESS:
                # out-of-order mini-GoP pyramid with hidden anchors +
                # show_existing_frame display (models/ra.py; ref
                # pd_process.c RA GoP typing)
                from svt_av1_psy_tpu.models.ra import RaDriver
                enc.qp_scale_compress_strength = \
                    self.cfg.qp_scale_compress_strength
                self._ra = RaDriver(
                    enc, gop_levels=min(self.cfg.hierarchical_levels, 5),
                    keyint=0 if gop == 0 else gop,
                    tf_strength=(self.cfg.tf_strength
                                 if self.cfg.enable_tf else 0),
                    tf_adaptive=self.cfg.enable_tf == 2,
                    # dynamic mini-GoP follows content analysis (ref
                    # Docs/Appendix-Dynamic-Mini-GoP)
                    dynamic_gop=bool(self.cfg.scene_change_detection))
                # TPL r0/beta per-frame q from the GoP dependency flow
                # (ref src_ops_process.c:1784 tpl_mc_flow ->
                # rc_process.c:873 CRF qindex from r0)
                if self.cfg.enable_tpl_la:
                    self._ra.tpl_strength = 1.0
            if self.cfg.film_grain_denoise_strength > 0:
                # film-grain synthesis path (ref noise_model.c:2132
                # av1_denoise_and_model_run): estimate the AR grain
                # model from the RAW first frame, then encode DENOISED
                # sources — coding the noisy source while synthesizing
                # grain on top measured ~6.5 dB under the reference at
                # matched rates (round-4 cfg4). Estimation + denoise
                # happen lazily on the first send_picture.
                self._fg_denoise = True
            enc.enable_scenecut = bool(self.cfg.scene_change_detection)
            # per-block interpolation-filter search (ref
            # interpolation_filter_search; preset-gated like
            # enc_mode_config's ifs levels)
            enc.interp_search = preset <= 11
            # motion-mode search (ref enc_mode_config.c obmc_level /
            # wm_level: enabled at the quality-leaning presets)
            enc.obmc_search = preset <= 10
            enc.warp_search = preset <= 10
            # masked compound (wedge/diffwtd) on RA compound blocks
            enc.masked_compound_search = preset <= 10
            # inter-intra (smooth II blend; ref enc_mode_config.c
            # inter_intra_level)
            enc.interintra_search = preset <= 10
            # CfL chroma candidate (ref enc_mode_config.c cfl_level:
            # enabled at the quality presets)
            enc.cfl_search = preset <= 11
            # filter intra (ref enc_mode_config.c filter_intra_level)
            enc.fi_search = preset <= 10
            # TX_MODE_SELECT on intra frames: depth-1 tx split search
            # (ref enc_mode_config txs level; the funnel-width gate in
            # the C walk keeps p13 at largest-tx)
            enc.tx_split_search = preset <= 12
            # inter var-tx: depth-1 TX split on inter blocks (ref
            # tx_search.c inter tx depth; quality presets)
            enc.inter_tx_split = preset <= 9
            # PSY max-32-tx-size caps TX at 32x32 (README.md:67-69);
            # requires the tx split search to express the cap
            if self.cfg.max_32_tx_size:
                enc.max_tx32 = True
                enc.tx_split_search = True
            # screen content (--scm; ref enc_settings.c:1020 default
            # scm 2 auto-detect): detected/forced KEY frames route
            # through the full-RD palette+IBC walk (_encode_key_sc);
            # inter frames stay on the fast path referencing that key
            if self.cfg.screen_content_mode == 2:
                enc.scm_auto = True
            # restoration: auto (-1) follows the reference's preset
            # derivation — off at the fast presets (ref enc_mode_config.c
            # derives enable_restoration=0 for M10+), opt-in via
            # --enable-restoration 1
            enc.enable_lr = self.cfg.enable_restoration_filtering == 1 \
                or (self.cfg.enable_restoration_filtering == -1 and
                    preset <= 7)
        else:
            from svt_av1_psy_tpu.models.intra_encoder import IntraEncoder
            enc = IntraEncoder(width, height, qindex=qindex, bd=bd,
                               search_top_k=2 if preset >= 7 else 3)
            enc.gop_size = gop
            enc.enable_variance_boost = self.cfg.enable_variance_boost
            enc.vb_strength = self.cfg.variance_boost_strength
            enc.vb_octile = self.cfg.variance_octile
            # aq-mode 1: variance-based AV1 segments (seg syntax);
            # 2 = deltaq (variance boost covers that shape)
            enc.aq_mode = 1 if \
                self.cfg.enable_adaptive_quantization == 1 else 0
            # screen content tools (--scm): 1 forces palette + intra
            # block copy, 2 detects per key frame (ref scs
            # screen_content_mode derivation in pic_analysis_process.c)
            if self.cfg.screen_content_mode == 1:
                enc.screen_content = True
                enc.enable_intrabc = True
            elif self.cfg.screen_content_mode == 2:
                enc.scm_auto = True
        self._enc = enc
        self._frames = 0
        # library-level one-pass rate control (ref rc_process.c:3269 —
        # the reference keeps RC inside the library; the CLI merely
        # forwards flags). VBR/CBR target the configured bitrate; CRF
        # with a max_bit_rate caps the rate (the --mbr analog).
        self._rc = None
        from svt_av1_psy_tpu.config import RateControlMode
        rcm = self.cfg.rate_control_mode
        if rcm in (RateControlMode.VBR, RateControlMode.CBR) or \
                (rcm == RateControlMode.CQP_OR_CRF and
                 self.cfg.max_bit_rate > 0):
            from svt_av1_psy_tpu.models.ratecontrol import RateController
            fps = (self.cfg.frame_rate_numerator /
                   max(self.cfg.frame_rate_denominator, 1)) or 30.0
            if fps > 1000:
                fps /= 1000.0
            self._rc = RateController(
                mode=("vbr" if rcm == RateControlMode.VBR else
                      "cbr" if rcm == RateControlMode.CBR else "crf"),
                base_qindex=qindex,
                target_bps=self.cfg.target_bit_rate,
                max_bps=self.cfg.max_bit_rate,
                fps=fps, bd=bd,
                buf_size_ms=(self.cfg.vbv_bufsize
                             if self.cfg.vbv_bufsize > 0 else 1000),
                undershoot_pct=(self.cfg.under_shoot_pct
                                if self.cfg.under_shoot_pct >= 0 else 25),
                overshoot_pct=(self.cfg.over_shoot_pct
                               if self.cfg.over_shoot_pct >= 0 else 25),
                gop_size=gop, recode=False)

    def _fg_prepare(self, y, u, v):
        """Film-grain-synthesis source conditioning: on the first frame
        estimate the AR grain model + noise level from the RAW source
        and arm it as the stream's film_grain params; every frame then
        encodes DENOISED (ref noise_model.c denoise-and-model)."""
        if not getattr(self, "_fg_denoise", False):
            return y, u, v
        from svt_av1_psy_tpu.models.denoise import (denoise_frame,
                                                    estimate_noise_sigma)
        bd = self.cfg.encoder_bit_depth
        if getattr(self, "_fg_sigma", None) is None:
            from svt_av1_psy_tpu.models.film_grain import \
                estimate_film_grain
            full = max(estimate_noise_sigma(np.asarray(y), bd), 0.25)
            # denoise depth scales with --film-grain level (the
            # reference's denoise_noise_level role): higher levels
            # remove — and therefore re-synthesize — more of the grain
            lvl = min(int(self.cfg.film_grain_denoise_strength), 50)
            self._fg_sigma = full * lvl / 16.0
            dn = denoise_frame(y, u, v, self._fg_sigma, bd)
            # model exactly the REMOVED portion: synthesis restores what
            # the denoiser took out (ref noise_model.c denoiser-residual
            # modelling), so light denoise signals light grain
            resid = np.asarray(y).astype(np.int32) - dn[0].astype(np.int32)
            params = estimate_film_grain(np.asarray(y), np.asarray(u),
                                         np.asarray(v), bd,
                                         noise_field=resid)
            if params is not None:
                self._enc.film_grain = params
                self._enc.seq.film_grain_params_present = True
            return dn
        return denoise_frame(y, u, v, self._fg_sigma, bd)

    def encode(self, y, u, v):
        """send_picture + get_packet: encode one frame, return the
        EncodedFrame (payload + reconstruction). Display-order modes
        only — RA sessions must use send_picture()/flush()."""
        y, u, v = self._fg_prepare(y, u, v)
        assert self._ra is None, \
            "random-access reorders frames: use send_picture()/flush()"
        is_key = self._enc.gop_size == 1 or self._frames == 0 or (
            self._enc.gop_size > 1 and
            self._frames % self._enc.gop_size == 0)
        if self._rc is not None:
            self._enc.qindex = max(1, min(255,
                                          self._rc.frame_qindex(is_key)))
        out = self._enc.encode_frame(y, u, v)
        if self._rc is not None:
            # feed back the ACTUALLY coded base q (kf boost / luma bias /
            # TPL ladders override the session q) and the encoder's own
            # frame-type verdict (scene cuts re-key inside encode_frame)
            self._rc.update(
                getattr(self._enc, "_last_coded_q", self._enc.qindex),
                8 * len(out.payload),
                getattr(self._enc, "_last_is_key", is_key))
        self._frames += 1
        return out

    def send_picture(self, y, u, v):
        """Queue one source frame; returns finished packets in DECODE
        order (list of models.ra.RaPacket). Low-delay modes return one
        shown packet per call; RA buffers a mini-GoP and returns its
        packets when complete (the send_picture/get_packet split of
        ref EbSvtAv1Enc.h)."""
        from svt_av1_psy_tpu.models.ra import RaPacket
        if self._ra is not None:
            y, u, v = self._fg_prepare(y, u, v)
            self._frames += 1
            if self._rc is not None:
                # GoP-granular in RA (recode disabled at fast presets,
                # like the reference)
                self._enc.qindex = max(1, min(
                    255, self._rc.frame_qindex(is_key=False)))
            pkts = self._ra.push(y, u, v)
            self._rc_track(pkts)
            return pkts
        out = self.encode(y, u, v)
        return [RaPacket(out.payload, self._frames - 1,
                         (out.recon_y, out.recon_u, out.recon_v))]

    def _rc_track(self, pkts):
        if self._rc is None:
            return
        for p in pkts:
            # qindex >= 0 marks TUs that actually code a frame
            # (show_existing TUs repeat a stored recon and carry no coded
            # q); keys are flagged by the RA driver so their bit spike is
            # modelled as key, not inter
            if p.qindex >= 0:
                self._rc.update(p.qindex, 8 * len(p.payload),
                                is_key=p.is_key)

    def flush(self):
        """End of stream: drain the buffered mini-GoP tail (RA)."""
        if self._ra is not None:
            pkts = self._ra.flush()
            self._rc_track(pkts)
            return pkts
        return []

    @property
    def frames_encoded(self) -> int:
        return self._frames

    def close(self) -> None:
        """svt_av1_enc_deinit analog (ref enc_handle.c:2748): join every
        background thread (deferred leaf filters, device warm-up) so no
        daemon thread dies at interpreter teardown. Idempotent. Does NOT
        flush — call flush() first to drain buffered RA frames."""
        if self._ra is not None:
            self._ra.close()
        else:
            close = getattr(self._enc, "close", None)
            if close is not None:
                close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stream_header(self) -> bytes:
        """svt_av1_enc_stream_header analog: standalone sequence header."""
        from svt_av1_psy_tpu.bitstream.headers import write_sequence_header
        from svt_av1_psy_tpu.bitstream.obu import ObuType, wrap_obu
        return wrap_obu(ObuType.SEQUENCE_HEADER,
                        write_sequence_header(self._enc.seq))
