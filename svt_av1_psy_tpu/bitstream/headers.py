"""AV1 sequence / frame header payload writers (spec 5.5, 5.9).

Equivalent of the reference's header emission in entropy_coding.c
(svt_aom_encode_sps_av1, write_frame_header_av1 — ref:
Source/Lib/Codec/entropy_coding.c) but organized as pure functions over two
small parameter dataclasses. Only features the encoder actually emits are
written; every field follows the spec bit order exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from svt_av1_psy_tpu.bitstream.bitwriter import BitWriter
from svt_av1_psy_tpu.bitstream.obu import ObuType, wrap_obu

PRIMARY_REF_NONE = 7


@dataclass
class SequenceParams:
    """Everything needed to emit sequence_header_obu (spec 5.5.1)."""
    width: int
    height: int
    bit_depth: int = 8            # 8 or 10
    profile: int = 0              # 0: 4:2:0 up to 10-bit
    still_picture: bool = False
    level_idx: int = 31           # 31 = MAX (no level constraints)
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = True
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = True
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    order_hint_bits: int = 7
    enable_superres: bool = False
    enable_cdef: bool = True
    enable_restoration: bool = True
    # color config
    color_range: int = 0          # 0 = studio swing
    color_primaries: int = 2      # unspecified
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False
    timing_info_present: bool = False

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64

    @property
    def frame_width_bits(self) -> int:
        return max(self.width - 1, 1).bit_length()

    @property
    def frame_height_bits(self) -> int:
        return max(self.height - 1, 1).bit_length()


def write_sequence_header(seq: SequenceParams) -> bytes:
    """sequence_header_obu payload (spec 5.5.1), wrapped by caller."""
    w = BitWriter()
    w.f(seq.profile, 3)
    w.bit(seq.still_picture)
    w.bit(0)                                  # reduced_still_picture_header
    w.bit(seq.timing_info_present)            # timing_info_present_flag (0)
    assert not seq.timing_info_present
    w.bit(0)                                  # initial_display_delay_present
    w.f(0, 5)                                 # operating_points_cnt_minus_1
    w.f(0, 12)                                # operating_point_idc[0]
    w.f(seq.level_idx, 5)                     # seq_level_idx[0]
    if seq.level_idx > 7:
        w.bit(0)                              # seq_tier[0]
    w.f(seq.frame_width_bits - 1, 4)
    w.f(seq.frame_height_bits - 1, 4)
    w.f(seq.width - 1, seq.frame_width_bits)
    w.f(seq.height - 1, seq.frame_height_bits)
    w.bit(0)                                  # frame_id_numbers_present_flag
    w.bit(seq.use_128x128_superblock)
    w.bit(seq.enable_filter_intra)
    w.bit(seq.enable_intra_edge_filter)
    w.bit(seq.enable_interintra_compound)
    w.bit(seq.enable_masked_compound)
    w.bit(seq.enable_warped_motion)
    w.bit(seq.enable_dual_filter)
    w.bit(seq.enable_order_hint)
    if seq.enable_order_hint:
        w.bit(seq.enable_jnt_comp)
        w.bit(seq.enable_ref_frame_mvs)
    w.bit(1)                                  # seq_choose_screen_content_tools
    # -> seq_force_screen_content_tools = SELECT_SCREEN_CONTENT_TOOLS (2)
    w.bit(0)                                  # seq_choose_integer_mv = 0
    w.bit(0)                                  # seq_force_integer_mv = 0
    if seq.enable_order_hint:
        w.f(seq.order_hint_bits - 1, 3)
    w.bit(seq.enable_superres)
    w.bit(seq.enable_cdef)
    w.bit(seq.enable_restoration)
    _write_color_config(w, seq)
    w.bit(seq.film_grain_params_present)
    w.trailing_bits()
    return w.data()


def _write_color_config(w: BitWriter, seq: SequenceParams) -> None:
    """spec 5.5.2 (4:2:0 profiles only for now)."""
    assert seq.bit_depth in (8, 10)
    w.bit(seq.bit_depth == 10)                # high_bitdepth
    w.bit(0)                                  # mono_chrome
    describe = not (seq.color_primaries == 2 and
                    seq.transfer_characteristics == 2 and
                    seq.matrix_coefficients == 2)
    w.bit(describe)                           # color_description_present_flag
    if describe:
        w.f(seq.color_primaries, 8)
        w.f(seq.transfer_characteristics, 8)
        w.f(seq.matrix_coefficients, 8)
    # not RGB identity path -> color_range + subsampling
    w.bit(seq.color_range)
    # profile 0: subsampling_x = subsampling_y = 1 (implied, not coded)
    assert seq.profile == 0
    w.f(seq.chroma_sample_position, 2)
    w.bit(seq.separate_uv_delta_q)


@dataclass
class FilmGrainParams:
    """Film-grain synthesis parameters (spec 5.9.30; ref grainSynthesis.c).

    scaling_* are lists of (value, scaling) piecewise points; ar_coeffs_*
    are signed ints in [-128, 127]."""
    apply_grain: bool = True
    grain_seed: int = 7391
    scaling_y: list = None
    scaling_cb: list = None
    scaling_cr: list = None
    chroma_scaling_from_luma: bool = False
    grain_scaling: int = 8                    # 8..11
    ar_coeff_lag: int = 2
    ar_coeffs_y: list = None
    ar_coeffs_cb: list = None
    ar_coeffs_cr: list = None
    ar_coeff_shift: int = 6                   # 6..9
    grain_scale_shift: int = 0
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: bool = True
    clip_to_restricted_range: bool = False

    def __post_init__(self):
        for a in ("scaling_y", "scaling_cb", "scaling_cr", "ar_coeffs_y",
                  "ar_coeffs_cb", "ar_coeffs_cr"):
            if getattr(self, a) is None:
                setattr(self, a, [])


@dataclass
class FrameParams:
    """Per-frame header state for an intra (KEY) frame; extended for inter."""
    frame_type: int = 0                       # 0=KEY 1=INTER 2=INTRA_ONLY 3=S
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = False
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    allow_intrabc: bool = False               # key frames only (spec 5.9.2)
    # super-resolution (spec 5.9.8): frame coded at
    # (width*8 + denom/2)/denom, upscaled after CDEF (needs
    # seq.enable_superres; intra frames only in this encoder)
    use_superres: bool = False
    superres_denom: int = 8
    order_hint: int = 0
    refresh_frame_flags: int = 0xFF
    # MFMV temporal MV prediction (needs seq.enable_ref_frame_mvs)
    use_ref_frame_mvs: bool = False
    # motion-mode (OBMC/WARPED) signalling per block
    is_motion_mode_switchable: bool = False
    allow_warped_motion: bool = False
    # quantization
    base_q_idx: int = 60
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 15
    qm_u: int = 15
    qm_v: int = 15
    # tiles (uniform spacing only)
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    min_tile_cols_log2: int = 0
    max_tile_cols_log2: int = 6
    min_tile_rows_log2: int = 0
    max_tile_rows_log2: int = 6
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    film_grain: object = None                 # Optional[FilmGrainParams]
    # loop filter
    filter_level: tuple = (0, 0)              # luma v/h
    filter_level_uv: tuple = (0, 0)
    sharpness: int = 0
    loop_filter_delta_enabled: bool = False
    # inter
    primary_ref_frame: int = 7
    refresh_frame_flags: int = 0x01
    ref_frame_idx: tuple = (0, 0, 0, 0, 0, 0, 0)
    allow_high_precision_mv: bool = False
    interp_filter: int = 0
    is_filter_switchable: bool = False    # per-block filter signalling
    # segmentation (spec 5.9.14): aq-mode-1 shape — ALT_Q only, spatial
    # map updated every frame. seg_altq[i] = delta or None (disabled)
    seg_enabled: bool = False
    seg_altq: tuple = (None,) * 8
    # compound prediction (spec 5.9.2 reference_select + 5.9.22
    # skip_mode_params); skip_mode_allowed must equal the decoder's
    # derivation from the ref order hints (the bit is only coded then)
    reference_select: bool = False
    skip_mode_allowed: bool = False
    skip_mode_present: bool = False
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri: tuple = (0,)
    cdef_y_sec: tuple = (0,)
    cdef_uv_pri: tuple = (0,)
    cdef_uv_sec: tuple = (0,)
    # restoration: 0=NONE 1=WIENER 2=SGRPROJ 3=SWITCHABLE per plane
    lr_type: tuple = (0, 0, 0)
    lr_unit_shift: int = 0                    # 64<<shift luma unit size
    lr_uv_shift: int = 0
    # global motion: per-ref (LAST..ALTREF) TRANSLATION wmmat[0:2] in
    # 1/(1<<16)px, or None for identity; gm_prev = PrevGmParams of the
    # primary reference frame (spec 5.9.24)
    gm_trans: tuple = None                    # 7x Optional[(wm0, wm1)]
    gm_prev: tuple = None                     # 7x (wm0, wm1)
    # modes
    tx_mode_select: bool = False              # False => TX_MODE_LARGEST
    reduced_tx_set: bool = False
    delta_q_present: bool = False
    delta_q_res_log2: int = 0
    # derived
    @property
    def is_intra(self) -> bool:
        return self.frame_type in (0, 2)

    @property
    def coded_lossless(self) -> bool:
        return (self.base_q_idx == 0 and self.delta_q_y_dc == 0 and
                self.delta_q_u_dc == 0 and self.delta_q_u_ac == 0 and
                self.delta_q_v_dc == 0 and self.delta_q_v_ac == 0)


def _write_delta_q(w: BitWriter, v: int) -> None:
    if v:
        w.bit(1)
        w.su(v, 7)  # su(1+6)
    else:
        w.bit(0)


def write_frame_header_bits(w: BitWriter, seq: SequenceParams,
                            fr: FrameParams) -> None:
    """uncompressed_header (spec 5.9.2) into an existing writer, NOT
    byte-aligned (caller appends tile data for an OBU_FRAME or trailing
    bits for an OBU_FRAME_HEADER). KEY/INTRA_ONLY and single-ref INTER
    frames (no superres/scaling, uniform single tile)."""
    if not fr.is_intra:
        _write_inter_header_head(w, seq, fr)
    else:
        _write_intra_header_head(w, seq, fr)
    if not fr.disable_cdf_update:
        w.bit(0)                              # disable_frame_end_update_cdf
    _write_tile_info(w, seq, fr)
    _write_quantization_params(w, seq, fr)
    # segmentation_params (spec 5.9.14)
    w.bit(int(fr.seg_enabled))
    if fr.seg_enabled:
        if fr.primary_ref_frame != 7:
            w.bit(1)                          # segmentation_update_map
            w.bit(0)                          # segmentation_temporal_update
            w.bit(1)                          # segmentation_update_data
        for i in range(8):
            for j in range(8):
                if j == 0 and fr.seg_altq[i] is not None:
                    w.bit(1)
                    v = max(-255, min(255, int(fr.seg_altq[i])))
                    w.f(v & 0x1FF, 9)         # su(1+8) two's complement
                else:
                    w.bit(0)
    # delta_q_params
    if fr.base_q_idx > 0:
        w.bit(fr.delta_q_present)
    if fr.delta_q_present:
        w.f(fr.delta_q_res_log2, 2)
        if not fr.allow_intrabc:
            w.bit(0)                          # delta_lf_present
    _write_loop_filter_params(w, seq, fr)
    _write_cdef_params(w, seq, fr)
    _write_lr_params(w, seq, fr)
    if not fr.coded_lossless:
        w.bit(fr.tx_mode_select)
    if not fr.is_intra:
        w.bit(fr.reference_select)
        if fr.reference_select and fr.skip_mode_allowed:
            w.bit(fr.skip_mode_present)       # skip_mode_params (5.9.22)
        if seq.enable_warped_motion:
            w.bit(int(fr.allow_warped_motion))
    w.bit(fr.reduced_tx_set)
    if not fr.is_intra:
        # global_motion_params (spec 5.9.24): TRANSLATION or ROTZOOM
        # per ref (a 2-tuple codes translation, a 6-tuple mat codes
        # ROTZOOM); deltas vs the primary reference frame's params (ref
        # entropy_coding.c:2958 write_global_motion_params)
        from svt_av1_psy_tpu.inter.global_motion import (
            write_rotzoom_params, write_translation_params)
        for ref in range(7):
            wm = fr.gm_trans[ref] if fr.gm_trans else None
            w.bit(wm is not None)             # is_global
            if wm is not None:
                prev = fr.gm_prev[ref] if fr.gm_prev else (0, 0)
                if len(wm) == 6:
                    w.bit(1)                  # is_rot_zoom
                    write_rotzoom_params(w, wm, prev,
                                         fr.allow_high_precision_mv)
                else:
                    w.bit(0)                  # is_rot_zoom
                    w.bit(1)                  # is_translation
                    if prev is not None and len(prev) == 6:
                        prev = prev[:2]
                    write_translation_params(w, wm, prev or (0, 0),
                                             fr.allow_high_precision_mv)
    _write_film_grain_params(w, seq, fr)


def _write_film_grain_params(w: BitWriter, seq: SequenceParams,
                             fr: FrameParams) -> None:
    """film_grain_params (spec 5.9.30): AR-model grain table signalling
    for decoder-side synthesis (ref grainSynthesis.c; PSY adaptive grain
    noise_model.c:2132)."""
    if not (seq.film_grain_params_present and
            (fr.show_frame or fr.showable_frame)):
        return
    fg = fr.film_grain
    if fg is None or not fg.apply_grain:
        w.bit(0)                              # apply_grain
        return
    w.bit(1)
    w.f(fg.grain_seed & 0xFFFF, 16)
    if fr.frame_type == 1:
        w.bit(1)                              # update_grain (always re-code)
    w.f(len(fg.scaling_y), 4)
    for (v, s) in fg.scaling_y:
        w.f(v, 8)
        w.f(s, 8)
    w.bit(fg.chroma_scaling_from_luma)
    mono = False
    if not (mono or fg.chroma_scaling_from_luma or
            (len(fg.scaling_y) == 0)):
        w.f(len(fg.scaling_cb), 4)
        for (v, s) in fg.scaling_cb:
            w.f(v, 8)
            w.f(s, 8)
        w.f(len(fg.scaling_cr), 4)
        for (v, s) in fg.scaling_cr:
            w.f(v, 8)
            w.f(s, 8)
    w.f(fg.grain_scaling - 8, 2)
    w.f(fg.ar_coeff_lag, 2)
    num_pos_luma = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    if len(fg.scaling_y):
        assert len(fg.ar_coeffs_y) == num_pos_luma
        for c in fg.ar_coeffs_y:
            w.f(c + 128, 8)
        num_pos_chroma = num_pos_luma + 1
    else:
        num_pos_chroma = num_pos_luma
    if fg.chroma_scaling_from_luma or len(fg.scaling_cb):
        assert len(fg.ar_coeffs_cb) == num_pos_chroma
        for c in fg.ar_coeffs_cb:
            w.f(c + 128, 8)
    if fg.chroma_scaling_from_luma or len(fg.scaling_cr):
        assert len(fg.ar_coeffs_cr) == num_pos_chroma
        for c in fg.ar_coeffs_cr:
            w.f(c + 128, 8)
    w.f(fg.ar_coeff_shift - 6, 2)
    w.f(fg.grain_scale_shift, 2)
    if len(fg.scaling_cb):
        w.f(fg.cb_mult, 8)
        w.f(fg.cb_luma_mult, 8)
        w.f(fg.cb_offset, 9)
    if len(fg.scaling_cr):
        w.f(fg.cr_mult, 8)
        w.f(fg.cr_luma_mult, 8)
        w.f(fg.cr_offset, 9)
    w.bit(fg.overlap_flag)
    w.bit(fg.clip_to_restricted_range)


def _write_inter_header_head(w: BitWriter, seq: SequenceParams,
                             fr: FrameParams) -> None:
    w.bit(0)                                  # show_existing_frame
    w.f(1, 2)                                 # frame_type = INTER
    w.bit(fr.show_frame)
    if not fr.show_frame:
        w.bit(fr.showable_frame)              # hidden ARF: displayable via
                                              # show_existing_frame later
    w.bit(0)                                  # error_resilient_mode
    w.bit(fr.disable_cdf_update)
    w.bit(0)                                  # allow_screen_content_tools
    w.bit(0)                                  # frame_size_override_flag
    if seq.enable_order_hint:
        w.f(fr.order_hint & ((1 << seq.order_hint_bits) - 1),
            seq.order_hint_bits)
    w.f(fr.primary_ref_frame, 3)
    w.f(fr.refresh_frame_flags, 8)
    if seq.enable_order_hint:
        w.bit(0)                              # frame_refs_short_signaling
    for i in range(7):
        w.f(fr.ref_frame_idx[i], 3)
    # frame_size_with_refs not taken (no size override): frame_size() has
    # no bits, render_size one bit
    if seq.enable_superres:
        w.bit(0)
    w.bit(0)                                  # render size
    w.bit(fr.allow_high_precision_mv)         # (force_integer_mv == 0)
    w.bit(int(fr.is_filter_switchable))
    if not fr.is_filter_switchable:
        w.f(fr.interp_filter, 2)
    w.bit(int(fr.is_motion_mode_switchable))
    if seq.enable_ref_frame_mvs:
        w.bit(int(fr.use_ref_frame_mvs))


def _write_intra_header_head(w: BitWriter, seq: SequenceParams,
                             fr: FrameParams) -> None:
    w.bit(0)                                  # show_existing_frame
    w.f(fr.frame_type, 2)
    w.bit(fr.show_frame)
    if not fr.show_frame:
        w.bit(fr.showable_frame)
    if not (fr.frame_type == 3 or (fr.frame_type == 0 and fr.show_frame)):
        w.bit(fr.error_resilient_mode)
    w.bit(fr.disable_cdf_update)
    # seq_force_screen_content_tools == SELECT (2) -> coded per frame
    w.bit(fr.allow_screen_content_tools)
    if fr.allow_screen_content_tools:
        # seq_force_integer_mv = 0 and frame is intra -> force_integer_mv
        # would be read only for non-intra frames; nothing here.
        pass
    w.bit(0)                                  # frame_size_override_flag
    if seq.enable_order_hint:
        w.f(fr.order_hint & ((1 << seq.order_hint_bits) - 1),
            seq.order_hint_bits)
    # primary_ref_frame: intra -> PRIMARY_REF_NONE (not coded)
    if fr.frame_type == 0 and not fr.show_frame:
        w.f(fr.refresh_frame_flags, 8)
    elif fr.frame_type == 2:
        w.f(fr.refresh_frame_flags, 8)
    # frame_size(): override == 0 -> sizes from sequence header
    if seq.enable_superres:
        w.bit(int(fr.use_superres))           # superres_params (5.9.8)
        if fr.use_superres:
            w.f(fr.superres_denom - 9, 3)     # coded_denom
    w.bit(0)                                  # render_and_frame_size_different
    if fr.allow_screen_content_tools:
        w.bit(int(fr.allow_intrabc))


def tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def tile_info_bounds(seq: SequenceParams, coded_w: int = 0):
    """spec 5.9.15 derived bounds (uniform spacing):
    (min_log2_tile_cols, max_log2_tile_cols, min_log2_tile_rows_base,
    max_log2_tile_rows, min_log2_tiles). coded_w: the post-superres
    downscaled frame width when it differs from seq.width."""
    sb_shift = 7 if seq.use_128x128_superblock else 6
    sb_cols = ((coded_w or seq.width) + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (seq.height + (1 << sb_shift) - 1) >> sb_shift
    max_tile_width_sb = 4096 >> sb_shift
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_shift)
    min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    return (min_log2_tile_cols, max_log2_tile_cols, max_log2_tile_rows,
            min_log2_tiles)


def _write_tile_info(w: BitWriter, seq: SequenceParams, fr: FrameParams):
    """spec 5.9.15, uniform spacing only. Min/max bounds are DERIVED from the
    frame geometry (writing a stop bit when max==min shifts every later
    field and desyncs the whole frame)."""
    coded_w = 0
    if fr.use_superres:
        from svt_av1_psy_tpu.ops.resize import superres_coded_width
        coded_w = superres_coded_width(seq.width, fr.superres_denom)
    (min_log2_tile_cols, max_log2_tile_cols, max_log2_tile_rows,
     min_log2_tiles) = tile_info_bounds(seq, coded_w)
    assert fr.tile_cols_log2 >= min_log2_tile_cols, "too few tile cols"
    w.bit(1)                                  # uniform_tile_spacing_flag
    for _ in range(fr.tile_cols_log2 - min_log2_tile_cols):
        w.bit(1)
    if fr.tile_cols_log2 < max_log2_tile_cols:
        w.bit(0)
    min_log2_tile_rows = max(min_log2_tiles - fr.tile_cols_log2, 0)
    assert fr.tile_rows_log2 >= min_log2_tile_rows, "too few tile rows"
    for _ in range(fr.tile_rows_log2 - min_log2_tile_rows):
        w.bit(1)
    if fr.tile_rows_log2 < max_log2_tile_rows:
        w.bit(0)
    if fr.tile_cols_log2 > 0 or fr.tile_rows_log2 > 0:
        w.f(fr.context_update_tile_id, fr.tile_rows_log2 + fr.tile_cols_log2)
        w.f(fr.tile_size_bytes - 1, 2)


def _write_quantization_params(w: BitWriter, seq: SequenceParams,
                               fr: FrameParams):
    w.f(fr.base_q_idx, 8)
    _write_delta_q(w, fr.delta_q_y_dc)
    # NumPlanes > 1:
    if seq.separate_uv_delta_q:
        diff = not (fr.delta_q_u_dc == fr.delta_q_v_dc and
                    fr.delta_q_u_ac == fr.delta_q_v_ac)
        w.bit(diff)
    else:
        diff = False
    _write_delta_q(w, fr.delta_q_u_dc)
    _write_delta_q(w, fr.delta_q_u_ac)
    if diff:
        _write_delta_q(w, fr.delta_q_v_dc)
        _write_delta_q(w, fr.delta_q_v_ac)
    w.bit(fr.using_qmatrix)
    if fr.using_qmatrix:
        w.f(fr.qm_y, 4)
        w.f(fr.qm_u, 4)
        if seq.separate_uv_delta_q and diff:
            w.f(fr.qm_v, 4)


def _write_loop_filter_params(w: BitWriter, seq: SequenceParams,
                              fr: FrameParams):
    if fr.coded_lossless or fr.allow_intrabc:
        return
    w.f(fr.filter_level[0], 6)
    w.f(fr.filter_level[1], 6)
    if fr.filter_level[0] or fr.filter_level[1]:
        w.f(fr.filter_level_uv[0], 6)
        w.f(fr.filter_level_uv[1], 6)
    w.f(fr.sharpness, 3)
    w.bit(fr.loop_filter_delta_enabled)
    if fr.loop_filter_delta_enabled:
        w.bit(0)                              # loop_filter_delta_update

def _write_cdef_params(w: BitWriter, seq: SequenceParams, fr: FrameParams):
    if fr.coded_lossless or fr.allow_intrabc or not seq.enable_cdef:
        return
    w.f(fr.cdef_damping - 3, 2)
    w.f(fr.cdef_bits, 2)
    for i in range(1 << fr.cdef_bits):
        w.f(fr.cdef_y_pri[i], 4)
        w.f(fr.cdef_y_sec[i], 2)
        w.f(fr.cdef_uv_pri[i], 4)
        w.f(fr.cdef_uv_sec[i], 2)


def _write_lr_params(w: BitWriter, seq: SequenceParams, fr: FrameParams):
    if fr.coded_lossless or fr.allow_intrabc or not seq.enable_restoration:
        return
    uses_lr = any(t != 0 for t in fr.lr_type)
    uses_chroma_lr = fr.lr_type[1] != 0 or fr.lr_type[2] != 0
    for t in fr.lr_type:
        w.f(t, 2)
    if uses_lr:
        w.bit(fr.lr_unit_shift > 0)
        if fr.lr_unit_shift > 0:
            w.bit(fr.lr_unit_shift > 1)
        if uses_chroma_lr:  # subsampling_x == subsampling_y == 1
            w.bit(fr.lr_uv_shift)


def frame_obu_payload(seq: SequenceParams, fr: FrameParams,
                      tile_payload: bytes) -> bytes:
    """frame_obu(): uncompressed_header + byte_alignment + tile_group body.

    For NumTiles > 1 the caller pre-concatenates per-tile
    `tile_size_minus_1 le(TileSizeBytes)` fields into tile_payload (the
    tile_start_and_end_present flag is only coded for multi-tile-group
    streams, which we never emit)."""
    w = BitWriter()
    write_frame_header_bits(w, seq, fr)
    w.byte_align()
    w.write_bytes(tile_payload)
    return w.data()


def key_frame_temporal_unit(seq: SequenceParams, fr: FrameParams,
                            tile_payload: bytes, *,
                            with_seq_header: bool,
                            metadata: bytes = b"") -> bytes:
    """Assemble a temporal unit: TD [+ SeqHdr] [+ metadata OBUs] +
    Frame OBU (header+tiles). `metadata` carries pre-wrapped OBU bytes
    (HDR CLL/MDCV/T.35 — the metadata_handle.c array analog)."""
    from svt_av1_psy_tpu.bitstream.obu import temporal_delimiter

    out = temporal_delimiter()
    if with_seq_header:
        out += wrap_obu(ObuType.SEQUENCE_HEADER, write_sequence_header(seq))
    out += metadata
    out += wrap_obu(ObuType.FRAME, frame_obu_payload(seq, fr, tile_payload))
    return out


def show_existing_temporal_unit(slot: int) -> bytes:
    """TU displaying an already-decoded hidden frame (spec 5.9.2
    show_existing_frame=1 + frame_to_show_map_idx; the RA display path
    for hidden ARF/anchor frames — ref pack_show_existing analog in
    packetization_process.c)."""
    from svt_av1_psy_tpu.bitstream.obu import temporal_delimiter

    w = BitWriter()
    w.bit(1)                                  # show_existing_frame
    w.f(slot, 3)                              # frame_to_show_map_idx
    # no decoder model / frame ids in our sequence headers; the shown
    # frame is never a KEY frame here, so the header ends immediately
    w.bit(1)                                  # trailing_one_bit
    w.byte_align()
    return temporal_delimiter() + wrap_obu(ObuType.FRAME_HEADER, w.data())
