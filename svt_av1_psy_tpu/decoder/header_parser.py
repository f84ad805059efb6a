"""AV1 sequence/frame header parsers (decode side of bitstream/headers.py).

Part of the in-repo conformance decoder (the role libaom's RefDecoder plays
for the reference, ref: test/e2e_test/RefDecoder.cc). Parses the feature
subset this encoder emits plus what SVT-AV1 emits at simple settings;
asserts loudly on anything unsupported so tile parsing never silently
desyncs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from svt_av1_psy_tpu.bitstream.bitwriter import BitReader


@dataclass
class SeqInfo:
    profile: int = 0
    still_picture: bool = False
    width: int = 0
    height: int = 0
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_order_hint: bool = False
    order_hint_bits: int = 0
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    force_screen_content_tools: int = 0
    force_integer_mv: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    bit_depth: int = 8
    mono: bool = False
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False


def parse_sequence_header(payload: bytes) -> SeqInfo:
    r = BitReader(payload)
    s = SeqInfo()
    s.profile = r.f(3)
    s.still_picture = bool(r.f(1))
    reduced = r.f(1)
    assert not reduced, "reduced_still_picture_header unsupported"
    if r.f(1):                                 # timing_info_present
        raise NotImplementedError("timing_info")
    r.f(1)                                     # initial_display_delay_present
    op_cnt = r.f(5) + 1
    for i in range(op_cnt):
        r.f(12)                                # operating_point_idc
        level = r.f(5)
        if level > 7:
            r.f(1)                             # seq_tier
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.width = r.f(s.frame_width_bits) + 1
    s.height = r.f(s.frame_height_bits) + 1
    assert r.f(1) == 0, "frame_id_numbers unsupported"
    s.use_128x128_superblock = bool(r.f(1))
    s.enable_filter_intra = bool(r.f(1))
    s.enable_intra_edge_filter = bool(r.f(1))
    s.enable_interintra_compound = bool(r.f(1))
    s.enable_masked_compound = bool(r.f(1))
    s.enable_warped_motion = bool(r.f(1))
    s.enable_dual_filter = bool(r.f(1))
    s.enable_order_hint = bool(r.f(1))
    if s.enable_order_hint:
        s.enable_jnt_comp = bool(r.f(1))
        s.enable_ref_frame_mvs = bool(r.f(1))
    if r.f(1):                                 # seq_choose_screen_content
        s.force_screen_content_tools = 2
    else:
        s.force_screen_content_tools = r.f(1)
    if s.force_screen_content_tools > 0:
        if r.f(1):                             # seq_choose_integer_mv
            s.force_integer_mv = 2
        else:
            s.force_integer_mv = r.f(1)
    if s.enable_order_hint:
        s.order_hint_bits = r.f(3) + 1
    s.enable_superres = bool(r.f(1))
    s.enable_cdef = bool(r.f(1))
    s.enable_restoration = bool(r.f(1))
    # color_config
    high_bd = r.f(1)
    assert s.profile <= 1
    s.bit_depth = 10 if high_bd else 8
    s.mono = bool(r.f(1))
    assert not s.mono
    if r.f(1):                                 # color_description_present
        r.f(8), r.f(8), r.f(8)
    r.f(1)                                     # color_range
    if s.profile == 0:
        pass                                   # 420 implied
    r.f(2)                                     # chroma_sample_position
    s.separate_uv_delta_q = bool(r.f(1))
    s.film_grain_params_present = bool(r.f(1))
    return s


@dataclass
class FrameInfo:
    frame_type: int = 0
    show_frame: bool = True
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = 0
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    # super-resolution (spec 5.9.8): 0 = no superres (coded width =
    # seq.width); else the downscaled coded width
    use_superres: bool = False
    superres_denom: int = 8
    frame_width: int = 0
    order_hint: int = 0
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    segmentation_enabled: bool = False
    delta_q_present: bool = False
    delta_lf_present: bool = False
    filter_level: tuple = (0, 0)
    filter_level_uv: tuple = (0, 0)
    sharpness: int = 0
    loop_filter_delta_enabled: bool = False
    loop_filter_ref_deltas: list = None
    loop_filter_mode_deltas: list = None
    cdef_bits: int = 0
    cdef_damping: int = 3
    cdef_y_pri: list = None
    cdef_y_sec: list = None
    cdef_uv_pri: list = None
    cdef_uv_sec: list = None
    delta_q_res_log2: int = 0
    lr_type: list = None           # per plane: 0 NONE, 1 SW, 2 WIENER, 3 SGR
    lr_unit_size: list = None
    tx_mode_select: bool = False
    reduced_tx_set: bool = False
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    tile_col_starts: list = None   # SB-unit col starts, + sentinel sb_cols
    tile_row_starts: list = None   # SB-unit row starts, + sentinel sb_rows
    allow_intrabc: bool = False
    coded_lossless: bool = False
    header_bytes: int = 0      # byte offset where tile data starts (OBU_FRAME)
    # inter fields
    primary_ref_frame: int = 7
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: list = None
    allow_high_precision_mv: bool = False
    force_integer_mv: bool = False
    interp_filter: int = 0
    is_filter_switchable: bool = False
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    reference_select: bool = False
    skip_mode_present: bool = False
    allow_warped_motion: bool = False
    error_resilient: bool = False
    disable_frame_end_update_cdf: bool = True
    # per-ref TRANSLATION gm wmmat[0:2] (1/(1<<16)px) or None (identity)
    gm_trans: list = None
    # skip mode (spec 5.9.22): the derived compound ref pair (1-based)
    skip_mode_frame: tuple = (1, 2)


def _read_delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def parse_frame_header(payload: bytes, seq: SeqInfo,
                       ref_order_hints=None, ref_gm=None) -> FrameInfo:
    """Parse an intra (KEY) uncompressed_header from an OBU_FRAME payload."""
    r = BitReader(payload)
    fi = FrameInfo()
    fi.show_existing_frame = bool(r.f(1))
    if fi.show_existing_frame:
        # spec 5.9.2: frame_to_show_map_idx; no temporal-point info or
        # display-frame-id in our streams; rest of the header is absent
        fi.frame_to_show_map_idx = r.f(3)
        return fi
    fi.frame_type = r.f(2)
    assert fi.frame_type in (0, 1, 2), "switch frames unsupported"
    is_inter = fi.frame_type == 1
    frame_is_intra = fi.frame_type in (0, 2)
    fi.show_frame = bool(r.f(1))
    if not fi.show_frame:
        r.f(1)                                 # showable_frame
    if not (fi.frame_type == 3 or (fi.frame_type == 0 and fi.show_frame)):
        fi.error_resilient = bool(r.f(1))
    fi.disable_cdf_update = bool(r.f(1))
    if seq.force_screen_content_tools == 2:
        fi.allow_screen_content_tools = bool(r.f(1))
    else:
        fi.allow_screen_content_tools = bool(seq.force_screen_content_tools)
    if fi.allow_screen_content_tools:
        # the bit is read regardless of frame type (libaom
        # read_uncompressed_header); intra frames then force it to 1
        if seq.force_integer_mv == 2:
            fi.force_integer_mv = bool(r.f(1))
        else:
            fi.force_integer_mv = bool(seq.force_integer_mv)
    if frame_is_intra:
        fi.force_integer_mv = True
    size_override = r.f(1)
    assert not size_override
    if seq.enable_order_hint:
        fi.order_hint = r.f(seq.order_hint_bits)
    if not fi.error_resilient and not frame_is_intra:
        fi.primary_ref_frame = r.f(3)
    if not (fi.frame_type == 3 or (fi.frame_type == 0 and fi.show_frame)):
        fi.refresh_frame_flags = r.f(8)
    if is_inter:
        if seq.enable_order_hint and fi.error_resilient:
            for _ in range(8):
                r.f(seq.order_hint_bits)       # ref_order_hint[i]
        short_sig = False
        if seq.enable_order_hint:
            short_sig = bool(r.f(1))           # frame_refs_short_signaling
        assert not short_sig, "short ref signaling unsupported"
        fi.ref_frame_idx = [r.f(3) for _ in range(7)]
        # frame_size_with_refs only when size override allowed (dav1d
        # read_frame_size use_ref = !error_resilient && size_override)
        if size_override and not fi.error_resilient:
            found = False
            for _ in range(7):
                if r.f(1):
                    found = True
                    break
            if not found:
                if seq.enable_superres:
                    assert r.f(1) == 0, "superres unsupported"
                assert r.f(1) == 0, "render size unsupported"
            elif seq.enable_superres:
                assert r.f(1) == 0, "superres unsupported"
        else:
            if seq.enable_superres:
                assert r.f(1) == 0, "superres unsupported"
            assert r.f(1) == 0, "render size unsupported"
        if not fi.force_integer_mv:
            fi.allow_high_precision_mv = bool(r.f(1))
        fi.is_filter_switchable = bool(r.f(1))
        if not fi.is_filter_switchable:
            fi.interp_filter = r.f(2)
        fi.is_motion_mode_switchable = bool(r.f(1))
        if not fi.error_resilient and seq.enable_ref_frame_mvs:
            fi.use_ref_frame_mvs = bool(r.f(1))
    else:
        if seq.enable_superres:
            # superres_params (spec 5.9.8): frame coded at the
            # downscaled width, upscaled after CDEF (spec 7.16)
            fi.use_superres = bool(r.f(1))
            if fi.use_superres:
                fi.superres_denom = r.f(3) + 9
                fi.frame_width = (seq.width * 8 +
                                  fi.superres_denom // 2) // \
                    fi.superres_denom
        assert r.f(1) == 0, "render size unsupported"
        if fi.allow_screen_content_tools:
            fi.allow_intrabc = bool(r.f(1))
    if not fi.disable_cdf_update:
        fi.disable_frame_end_update_cdf = bool(r.f(1))
    else:
        fi.disable_frame_end_update_cdf = True
    # tile_info (uniform only); geometry from the CODED (post-superres
    # downscale) frame width
    coded_w = fi.frame_width or seq.width
    sb_shift = 7 if seq.use_128x128_superblock else 6
    sb_cols = (coded_w + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (seq.height + (1 << sb_shift) - 1) >> sb_shift
    sb_size_log2 = sb_shift
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    assert r.f(1) == 1, "non-uniform tiles unsupported"
    fi.tile_cols_log2 = min_log2_tile_cols
    while fi.tile_cols_log2 < max_log2_tile_cols:
        if not r.f(1):
            break
        fi.tile_cols_log2 += 1
    min_log2_tile_rows = max(min_log2_tiles - fi.tile_cols_log2, 0)
    fi.tile_rows_log2 = min_log2_tile_rows
    while fi.tile_rows_log2 < max_log2_tile_rows:
        if not r.f(1):
            break
        fi.tile_rows_log2 += 1
    if fi.tile_cols_log2 or fi.tile_rows_log2:
        fi.context_update_tile_id = r.f(fi.tile_cols_log2 +
                                        fi.tile_rows_log2)
        fi.tile_size_bytes = r.f(2) + 1
    # uniform tile grid in SB units (spec tile_info MiColStarts/MiRowStarts)
    tw_sb = (sb_cols + (1 << fi.tile_cols_log2) - 1) >> fi.tile_cols_log2
    th_sb = (sb_rows + (1 << fi.tile_rows_log2) - 1) >> fi.tile_rows_log2
    fi.tile_col_starts = list(range(0, sb_cols, tw_sb)) + [sb_cols]
    fi.tile_row_starts = list(range(0, sb_rows, th_sb)) + [sb_rows]
    # quantization_params
    fi.base_q_idx = r.f(8)
    fi.delta_q_y_dc = _read_delta_q(r)
    if seq.separate_uv_delta_q:
        diff_uv = bool(r.f(1))
    else:
        diff_uv = False
    fi.delta_q_u_dc = _read_delta_q(r)
    fi.delta_q_u_ac = _read_delta_q(r)
    if diff_uv:
        fi.delta_q_v_dc = _read_delta_q(r)
        fi.delta_q_v_ac = _read_delta_q(r)
    else:
        fi.delta_q_v_dc = fi.delta_q_u_dc
        fi.delta_q_v_ac = fi.delta_q_u_ac
    fi.using_qmatrix = bool(r.f(1))
    if fi.using_qmatrix:
        fi.qm_y = r.f(4)
        fi.qm_u = r.f(4)
        if seq.separate_uv_delta_q and diff_uv:
            fi.qm_v = r.f(4)
        else:
            fi.qm_v = fi.qm_u
    # segmentation_params (spec 5.9.14)
    fi.segmentation_enabled = bool(r.f(1))
    fi.seg_update_map = False
    fi.seg_temporal_update = False
    fi.seg_update_data = False
    fi.seg_feature_enabled = [[False] * 8 for _ in range(8)]
    fi.seg_feature_data = [[0] * 8 for _ in range(8)]
    fi.seg_id_pre_skip = False
    fi.seg_last_active = 0
    fi.seg_inherit = False
    if fi.segmentation_enabled:
        if fi.primary_ref_frame == 7:
            fi.seg_update_map = True
            fi.seg_update_data = True
        else:
            fi.seg_update_map = bool(r.f(1))
            if fi.seg_update_map:
                fi.seg_temporal_update = bool(r.f(1))
            fi.seg_update_data = bool(r.f(1))
        if fi.seg_update_data:
            bits = (8, 6, 6, 6, 6, 3, 0, 0)
            signed = (1, 1, 1, 1, 1, 0, 0, 0)
            fmax = (255, 63, 63, 63, 63, 7, 0, 0)
            for i in range(8):
                for j in range(8):
                    if not r.f(1):
                        continue
                    fi.seg_feature_enabled[i][j] = True
                    v = 0
                    if bits[j]:
                        if signed[j]:
                            v = r.f(bits[j] + 1)
                            if v >= (1 << bits[j]):       # su(): sign bit
                                v -= (1 << (bits[j] + 1))
                            v = max(-fmax[j], min(fmax[j], v))
                        else:
                            v = min(fmax[j], r.f(bits[j]))
                    fi.seg_feature_data[i][j] = v
        else:
            # inherit the primary ref frame's feature data (spec: the
            # previous data persists); driver substitutes via ref_seg
            fi.seg_inherit = True
        for i in range(8):
            for j in range(8):
                if fi.seg_feature_enabled[i][j]:
                    fi.seg_last_active = i
                    if j >= 5:                  # SEG_LVL_REF_FRAME..
                        fi.seg_id_pre_skip = True
    fi.coded_lossless = (fi.base_q_idx == 0 and fi.delta_q_y_dc == 0 and
                         fi.delta_q_u_dc == 0 and fi.delta_q_u_ac == 0 and
                         fi.delta_q_v_dc == 0 and fi.delta_q_v_ac == 0)
    # delta_q_params
    if fi.base_q_idx > 0:
        fi.delta_q_present = bool(r.f(1))
    if fi.delta_q_present:
        fi.delta_q_res_log2 = r.f(2)
        if not fi.allow_intrabc:               # spec delta_lf_params gate
            fi.delta_lf_present = bool(r.f(1))
            if fi.delta_lf_present:
                r.f(2)                         # delta_lf_res
                r.f(1)                         # delta_lf_multi
    # loop_filter_params
    if not (fi.coded_lossless or fi.allow_intrabc):
        l0 = r.f(6)
        l1 = r.f(6)
        fi.filter_level = (l0, l1)
        if l0 or l1:
            fi.filter_level_uv = (r.f(6), r.f(6))
        fi.sharpness = r.f(3)
        fi.loop_filter_delta_enabled = bool(r.f(1))
        fi.loop_filter_ref_deltas = [1, 0, 0, 0, 0, -1, -1, -1]
        fi.loop_filter_mode_deltas = [0, 0]
        if fi.loop_filter_delta_enabled:
            if r.f(1):                         # delta_update
                for i in range(8):
                    if r.f(1):
                        fi.loop_filter_ref_deltas[i] = r.su(7)
                for i in range(2):
                    if r.f(1):
                        fi.loop_filter_mode_deltas[i] = r.su(7)
    # cdef_params
    if not (fi.coded_lossless or fi.allow_intrabc) and seq.enable_cdef:
        fi.cdef_damping = r.f(2) + 3
        fi.cdef_bits = r.f(2)
        fi.cdef_y_pri, fi.cdef_y_sec = [], []
        fi.cdef_uv_pri, fi.cdef_uv_sec = [], []
        for _ in range(1 << fi.cdef_bits):
            fi.cdef_y_pri.append(r.f(4))
            fi.cdef_y_sec.append(r.f(2))
            fi.cdef_uv_pri.append(r.f(4))
            fi.cdef_uv_sec.append(r.f(2))
    # lr_params (spec 5.9.20); Remap_Lr_Type = NONE,SWITCHABLE,WIENER,SGR
    if not (fi.coded_lossless or fi.allow_intrabc) and seq.enable_restoration:
        remap = [0, 3, 1, 2]   # coded value -> RESTORE_{NONE,WIENER,SGR,SW}
        fi.lr_type = [remap[r.f(2)] for _ in range(3)]
        uses_lr = any(fi.lr_type)
        uses_chroma_lr = fi.lr_type[1] or fi.lr_type[2]
        fi.lr_unit_size = [256, 256, 256]
        if uses_lr:
            if seq.use_128x128_superblock:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            fi.lr_unit_size[0] = 256 >> (2 - shift)
            uv = 0
            if uses_chroma_lr:
                uv = r.f(1)
            fi.lr_unit_size[1] = fi.lr_unit_size[0] >> uv
            fi.lr_unit_size[2] = fi.lr_unit_size[1]
    # read_tx_mode
    if not fi.coded_lossless:
        fi.tx_mode_select = bool(r.f(1))
    if is_inter:
        fi.reference_select = bool(r.f(1))
        # skip_mode_params (spec 5.9.22): allowed when compound mode is
        # selectable and the DPB holds refs on both temporal sides
        if fi.reference_select and seq.enable_order_hint and \
                ref_order_hints is not None:
            def rel(a, b):
                d = a - b
                m = 1 << (seq.order_hint_bits - 1)
                return (d & (m - 1)) - (d & m)
            hints = [ref_order_hints[fi.ref_frame_idx[k]] for k in range(7)]
            fwd_idx = bwd_idx = -1
            fwd_hint = bwd_hint = None
            for k, h in enumerate(hints):
                if rel(h, fi.order_hint) < 0:
                    if fwd_hint is None or rel(h, fwd_hint) > 0:
                        fwd_idx, fwd_hint = k, h
                elif rel(h, fi.order_hint) > 0:
                    if bwd_hint is None or rel(h, bwd_hint) < 0:
                        bwd_idx, bwd_hint = k, h
            allowed = False
            if fwd_idx >= 0:
                if bwd_idx >= 0:
                    allowed = True
                    fi.skip_mode_frame = (1 + min(fwd_idx, bwd_idx),
                                          1 + max(fwd_idx, bwd_idx))
                else:
                    # two forward refs with distinct hints (spec 5.9.22)
                    snd_idx, snd = -1, None
                    for k, h in enumerate(hints):
                        if rel(h, fwd_hint) < 0:
                            if snd is None or rel(h, snd) > 0:
                                snd_idx, snd = k, h
                    if snd_idx >= 0:
                        allowed = True
                        fi.skip_mode_frame = (1 + min(fwd_idx, snd_idx),
                                              1 + max(fwd_idx, snd_idx))
            if allowed:
                fi.skip_mode_present = bool(r.f(1))
        if seq.enable_warped_motion:
            fi.allow_warped_motion = bool(r.f(1))
    fi.reduced_tx_set = bool(r.f(1))
    if is_inter:
        # global_motion_params (spec 5.9.24): TRANSLATION + ROTZOOM;
        # deltas are coded against the primary reference frame's saved
        # params (ref entropy_coding.c:2958 / dec read_global_motion).
        # gm_trans[ref]: 2-tuple (translation wm0/wm1) or 6-tuple
        # (ROTZOOM mat).
        from svt_av1_psy_tpu.inter.global_motion import (
            read_rotzoom_params, read_translation_params)
        if fi.primary_ref_frame != 7 and ref_gm is not None:
            prev = ref_gm[fi.ref_frame_idx[fi.primary_ref_frame]]
        else:
            prev = ((0, 0),) * 7
        fi.gm_trans = [None] * 7
        for ref in range(7):
            if r.f(1):                         # is_global
                if r.f(1):                     # is_rot_zoom
                    fi.gm_trans[ref] = read_rotzoom_params(r, prev[ref])
                else:
                    assert r.f(1) == 1, "AFFINE gm unsupported"
                    pr = prev[ref]
                    if pr is not None and len(pr) == 6:
                        pr = pr[:2]
                    fi.gm_trans[ref] = read_translation_params(
                        r, pr or (0, 0), fi.allow_high_precision_mv)
    # film grain
    if seq.film_grain_params_present and fi.show_frame:
        if r.f(1):
            raise NotImplementedError("film grain parse")
    r.byte_align()
    fi.header_bytes = r.bit_pos // 8
    return fi


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k
