"""Variance-boost adaptive quantization (the PSY flagship AQ mode).

Per-64x64-superblock qindex offsets derived from the distribution of 8x8
source variances: low-variance (smooth / fine-gradient) superblocks get a
lower qindex so the psychovisually fragile areas keep detail.  Mirrors the
behavior of the reference's variance boost
(ref rc_process.c:1406 av1_get_deltaq_sb_variance_boost,
 rc_process.c:1516 svt_variance_adjust_qp,
 rc_process.c:1675 normalize_sb_delta_q) re-derived as vectorized array
ops over all superblocks at once: one reshape/reduction for the 8x8
variances and one sort over (n_sb, 64) for the octile statistics — a
vectorized formulation rather than the reference's per-SB scalar loop.

Defaults match the reference CLI: strength 2, octile 6, regular curve
(ref enc_settings.c:1098-1099).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from svt_av1_psy_tpu.ops.quant import ac_q

VAR_BOOST_MAX_DELTAQ_RANGE = 80
VAR_BOOST_MAX_QSTEP_RATIO_BOOST = 8.0
_STRENGTHS = (0.0, 0.65, 1.1, 1.6, 2.5)


def sb_8x8_variances(y: np.ndarray) -> np.ndarray:
    """Per-superblock 8x8 source variances.

    y: (H, W) luma, H and W multiples of 64 (pad first).
    Returns (n_sb_rows, n_sb_cols, 64) int32 — the 64 8x8 variances of
    each superblock in raster order (ref me variance array layout,
    ME_TIER_ZERO_PU_8x8_*).
    """
    H, W = y.shape
    assert H % 64 == 0 and W % 64 == 0
    x = y.astype(np.int64)
    # (sbr, 8, 8, sbc, 8, 8): superblock grid x 8x8-subblock grid x pixels
    t = x.reshape(H // 64, 8, 8, W // 64, 8, 8)
    s = t.sum(axis=(2, 5))
    ss = (t * t).sum(axis=(2, 5))
    var = (ss - ((s * s) >> 6)) >> 6
    # (sbr, sub_r, sbc, sub_c) -> (sbr, sbc, 64)
    var = var.transpose(0, 2, 1, 3).reshape(H // 64, W // 64, 64)
    return var.astype(np.int32)


@lru_cache(maxsize=None)
def _q_fp8_table(bd: int) -> np.ndarray:
    """qindex -> quantizer step in fp8 (ref rc_process.c:180
    svt_av1_convert_qindex_to_q_fp8)."""
    shift = {8: 6, 10: 4, 12: 3}[bd]
    return np.array([ac_q(i, bd) << shift for i in range(256)], np.int64)


def _compute_qdelta_fp(qstart_fp8, qtarget_fp8, bd: int) -> np.ndarray:
    """Vectorized ref rc_process.c:190 svt_av1_compute_qdelta_fp."""
    tab = _q_fp8_table(bd)[:255]          # C loop scans [0, 255)
    start = np.minimum(np.searchsorted(tab, qstart_fp8, side="left"), 254)
    target = np.minimum(np.searchsorted(tab, qtarget_fp8, side="left"), 254)
    return target - start


def variance_boost(base_q_idx: int, variances: np.ndarray,
                   strength: int = 2, octile: int = 6,
                   bd: int = 8) -> np.ndarray:
    """Per-SB qindex boost (positive = lower q) from 8x8 variances.

    variances: (..., 64) int array of per-SB 8x8 variances.
    Mirrors ref rc_process.c:1406 (regular curve)."""
    assert 1 <= octile <= 8 and 1 <= strength <= 4
    v = np.sort(variances.reshape(-1, 64), axis=1)
    mid = octile * 8 - 1
    low = max(7, mid - 8)
    upp = min(63, mid + 8)
    var = (v[:, low] + (v[:, mid] << 1) + v[:, upp] + 2) >> 2
    var = np.maximum(var, 1).astype(np.float64)

    ratio = np.power(1.018, _STRENGTHS[strength] * (-10 * np.log2(var) + 80))
    ratio = np.clip(ratio, 1.0, VAR_BOOST_MAX_QSTEP_RATIO_BOOST)

    base_fp8 = int(_q_fp8_table(bd)[base_q_idx])
    target_fp8 = (base_fp8 / ratio).astype(np.int64)
    qdelta = _compute_qdelta_fp(base_fp8, target_fp8, bd)
    boost = ((base_q_idx + 40) * -qdelta) // (255 + 40)
    boost = np.minimum(boost, VAR_BOOST_MAX_DELTAQ_RANGE)
    return boost.reshape(variances.shape[:-1]).astype(np.int32)


def adjust_sb_qindex(base_q_idx: int, variances: np.ndarray,
                     strength: int = 2, octile: int = 6, bd: int = 8):
    """Full frame AQ decision.

    Returns (frame_base_q, delta_q_res_log2, sb_qindex) where sb_qindex has
    the leading shape of `variances` (n_sb_rows, n_sb_cols).  Follows
    ref rc_process.c:1516 svt_variance_adjust_qp (readjust_base_q_idx) then
    rc_process.c:1675 normalize_sb_delta_q.
    """
    boost = variance_boost(base_q_idx, variances, strength, octile, bd)
    sbq = np.clip(base_q_idx - boost, 1, 255)

    rng = min(int(sbq.max() - sbq.min()), VAR_BOOST_MAX_DELTAQ_RANGE)
    norm_base = int(sbq.min()) + (rng >> 1)
    half = VAR_BOOST_MAX_DELTAQ_RANGE >> 1
    off = np.clip(sbq - norm_base, -half, half)
    sbq = np.clip(norm_base + off, 1, 255)

    # snap offsets to a delta_q_res grid sized to the operating qindex
    # (ref rc_process.c:1675): coarse res at high q where per-step qstep
    # jumps are small, fine res at low q
    if norm_base >= 160:
        res_log2 = 3
    elif norm_base >= 120:
        res_log2 = 2
    elif norm_base >= 80:
        res_log2 = 1
    else:
        res_log2 = 0
    if res_log2:
        res = 1 << res_log2
        mask = ~(res - 1)
        rem = norm_base & ~mask
        sbq = (sbq & mask) + rem
        sbq = np.where(sbq == 0, res, sbq)
    return norm_base, res_log2, sbq.astype(np.int32)
