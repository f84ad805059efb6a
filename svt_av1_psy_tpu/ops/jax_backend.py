"""JAX device backend: batched exact transforms, quantization and intra
prediction over superblock batches, and the encoder's search programs.

This is the device compute path that replaces the reference's 250k-LoC SIMD
backends (ref: Source/Lib/ASM_AVX2 et al, SURVEY.md §2.8): the same normative
integer math as the numpy trusted path (ops/transforms.py, ops/quant.py,
ops/intra.py), expressed over batched int32 tensors that XLA fuses into
device kernels. Equivalence tests pin device results to the numpy path
bit-exactly, and the integer search programs are bit-exact across backends.

All functions are jit-compatible with static tx/block geometry.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from svt_av1_psy_tpu.constants import PredMode
from svt_av1_psy_tpu.ops import transforms as tx
from svt_av1_psy_tpu.ops.intra import _SM_WEIGHTS
from svt_av1_psy_tpu.ops.quant import AOM_QM_BITS, PlaneQuant, tx_scale


# --- transforms -------------------------------------------------------------

def forward_transform_batch(resid: jnp.ndarray, tx_size: int,
                            tx_type: int, bd: int = 8) -> jnp.ndarray:
    """Batched exact forward transform: (..., h, w) int32 -> (..., ch, cw)."""
    return tx.forward_transform_2d(resid, tx_size, tx_type, bd, xp=jnp)


def inverse_transform_batch(coeff: jnp.ndarray, tx_size: int,
                            tx_type: int, bd: int = 8) -> jnp.ndarray:
    """Batched normative inverse transform: (..., ch, cw) -> (..., h, w)."""
    return tx.inverse_transform_2d(coeff, tx_size, tx_type, bd, xp=jnp)


def inverse_transform_add_batch(coeff, pred, tx_size, tx_type, bd=8):
    resid = inverse_transform_batch(coeff, tx_size, tx_type, bd)
    rec = pred.astype(jnp.int32) + resid
    return jnp.clip(rec, 0, (1 << bd) - 1)


# --- quantization -----------------------------------------------------------

def quantize_b_batch(coeff: jnp.ndarray, ts: int, pq: PlaneQuant,
                     qm: np.ndarray | None = None,
                     iqm: np.ndarray | None = None):
    """int32 quantize_b identical to ops/quant.quantize_b.

    Uses the identity (x * 2^(16-l)) >> (16-ls) == x >> (l-ls) so every
    product stays inside int32 (quant_shift is always a power of two)."""
    log_scale = tx_scale(ts)
    ch, cw = coeff.shape[-2:]
    is_dc = np.zeros((ch, cw), bool)
    is_dc[0, 0] = True

    def sel(pair):
        return jnp.where(is_dc, jnp.int32(int(pair[0])),
                         jnp.int32(int(pair[1])))

    rnd_half = (1 << log_scale) >> 1
    zbin = np.where(is_dc, (int(pq.zbin[0]) + rnd_half) >> log_scale,
                    (int(pq.zbin[1]) + rnd_half) >> log_scale).astype(np.int32)
    rnd = np.where(is_dc, (int(pq.round[0]) + rnd_half) >> log_scale,
                   (int(pq.round[1]) + rnd_half) >> log_scale).astype(np.int32)
    quant = sel(pq.quant)
    deq = sel(pq.dequant)
    # quant_shift = 1 << (16 - l)  ->  right shift by (l - log_scale)
    lshift = np.where(
        is_dc, 16 - int(np.log2(int(pq.quant_shift[0]))),
        16 - int(np.log2(int(pq.quant_shift[1])))).astype(np.int32)

    c = coeff.astype(jnp.int32)
    sign = jnp.where(c < 0, jnp.int32(-1), jnp.int32(1))
    abs_c = jnp.abs(c)

    wt = jnp.int32(1 << AOM_QM_BITS) if qm is None else jnp.asarray(
        qm, jnp.int32)
    iwt = jnp.int32(1 << AOM_QM_BITS) if iqm is None else jnp.asarray(
        iqm, jnp.int32)
    nz = abs_c * wt >= (jnp.asarray(zbin) << AOM_QM_BITS)

    tmp = jnp.clip(abs_c + jnp.asarray(rnd), -32768, 32767)
    if qm is None:
        tmp32 = (((tmp * quant) >> 16) + tmp) >> (
            jnp.asarray(lshift) - log_scale)
    else:
        # QM path: ((tmpw*quant)>>16)+tmpw == (tmpw*m)>>16 with
        # m = quant+2^16 > 0, and the nonnegative product splits exactly
        # into int32 pieces: tmpw = hi*2^11 + lo ->
        # (tmpw*m)>>16 == (hi*m + ((lo*m)>>11)) >> 5.
        tmpw = tmp * wt                      # <= 2^22, nonnegative
        m = quant + (1 << 16)                # <= 2^17, positive
        hi = tmpw >> 11
        lo = tmpw & 2047
        x = (hi * m + ((lo * m) >> 11)) >> 5
        tmp32 = x >> (jnp.asarray(lshift) - log_scale + AOM_QM_BITS)
    tmp32 = jnp.where(nz, tmp32, 0)
    dequant_w = (deq * iwt + (1 << (AOM_QM_BITS - 1))) >> AOM_QM_BITS
    abs_dq = (tmp32 * dequant_w) >> log_scale
    return (tmp32 * sign), (abs_dq * sign)


# --- intra prediction (batched over superblocks) ----------------------------

def predict_modes_batch(above: jnp.ndarray, left: jnp.ndarray,
                        above_left: jnp.ndarray, have_above: jnp.ndarray,
                        have_left: jnp.ndarray, w: int, h: int,
                        bd: int = 8) -> jnp.ndarray:
    """All supported non-directional predictors for a batch of blocks.

    above: (N, w) int32, left: (N, h), above_left/have_*: (N,).
    Returns (N, n_modes, h, w) with modes in SUPPORTED_MODES order:
    DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH."""
    n = above.shape[0]
    base = 1 << (bd - 1)
    a = above.astype(jnp.int32)
    l = left.astype(jnp.int32)
    al = above_left.astype(jnp.int32).reshape(n, 1, 1)

    # DC
    sum_a = a.sum(axis=1)
    sum_l = l.sum(axis=1)
    log2w = w.bit_length() - 1
    log2h = h.bit_length() - 1
    dc_both = (sum_a + sum_l + ((w + h) >> 1)) // (w + h)
    dc_a = (sum_a + (w >> 1)) >> log2w
    dc_l = (sum_l + (h >> 1)) >> log2h
    dc = jnp.where(have_above & have_left, dc_both,
                   jnp.where(have_above, dc_a,
                             jnp.where(have_left, dc_l, base)))
    dc_pred = jnp.broadcast_to(dc.reshape(n, 1, 1), (n, h, w))

    v_pred = jnp.broadcast_to(a.reshape(n, 1, w), (n, h, w))
    h_pred = jnp.broadcast_to(l.reshape(n, h, 1), (n, h, w))

    wx = jnp.asarray(_SM_WEIGHTS[w], jnp.int32).reshape(1, 1, w)
    wy = jnp.asarray(_SM_WEIGHTS[h], jnp.int32).reshape(1, h, 1)
    below = l[:, h - 1].reshape(n, 1, 1)
    right = a[:, w - 1].reshape(n, 1, 1)
    a3 = a.reshape(n, 1, w)
    l3 = l.reshape(n, h, 1)
    smooth = ((wy * a3 + (256 - wy) * below + wx * l3 + (256 - wx) * right
               + 256) >> 9)
    smooth_v = ((wy * a3 + (256 - wy) * below + 128) >> 8)
    smooth_h = ((wx * l3 + (256 - wx) * right + 128) >> 8)

    pbase = a3 + l3 - al
    pa = jnp.abs(pbase - a3)
    pl = jnp.abs(pbase - l3)
    pal = jnp.abs(pbase - al)
    paeth = jnp.where((pa <= pl) & (pa <= pal),
                      jnp.broadcast_to(a3, (n, h, w)),
                      jnp.where(pl <= pal, jnp.broadcast_to(l3, (n, h, w)),
                                jnp.broadcast_to(al, (n, h, w))))

    return jnp.stack([dc_pred, v_pred, h_pred, smooth, smooth_v, smooth_h,
                      paeth], axis=1)


SEARCH_MODE_ORDER = (int(PredMode.DC_PRED), int(PredMode.V_PRED),
                     int(PredMode.H_PRED), int(PredMode.SMOOTH_PRED),
                     int(PredMode.SMOOTH_V_PRED), int(PredMode.SMOOTH_H_PRED),
                     int(PredMode.PAETH_PRED),
                     # directional family (base angles, delta 0)
                     int(PredMode.D45_PRED), int(PredMode.D135_PRED),
                     int(PredMode.D113_PRED), int(PredMode.D157_PRED),
                     int(PredMode.D203_PRED), int(PredMode.D67_PRED))

_DIR_ANGLES = (45, 135, 113, 157, 203, 67)


def predict_directional_batch(above2: jnp.ndarray, left2: jnp.ndarray,
                              above_left: jnp.ndarray, size: int,
                              bd: int = 8) -> jnp.ndarray:
    """Batched directional predictors at base angles, delta 0, no edge
    filter (open-loop search approximation; the commit path re-predicts
    normatively). above2/left2: (N, 2*size) extended edges; returns
    (N, 6, size, size) in _DIR_ANGLES order."""
    from svt_av1_psy_tpu.ops.intra import _dr_maps_z1, _dr_maps_z2, \
        _dr_maps_z3
    n = above2.shape[0]
    w = h = size
    hi = (1 << bd) - 1
    al = above_left.astype(jnp.int32).reshape(n, 1)
    ab_ext = jnp.concatenate([al, above2.astype(jnp.int32)], axis=1)
    le_ext = jnp.concatenate([jnp.zeros((n, 1), jnp.int32), al,
                              left2.astype(jnp.int32)], axis=1)
    outs = []
    for angle in _DIR_ANGLES:
        if angle < 90:
            base, shift, _ = _dr_maps_z1(w, h, angle, 0, False)
            max_base = w + h - 1
            b = np.minimum(np.asarray(base), max_base)
            bj = jnp.asarray(b.reshape(-1) + 1)
            sj = jnp.asarray(np.broadcast_to(np.asarray(shift),
                                             (h, w)).reshape(-1))
            v = (ab_ext[:, bj] * (32 - sj) + ab_ext[:, bj + 1] * sj +
                 16) >> 5
            mask = jnp.asarray((np.asarray(base) < max_base).reshape(-1))
            v = jnp.where(mask, v, ab_ext[:, max_base + 1][:, None])
        elif angle < 180:
            (a_base, a_shift, use_above, l_base,
             l_shift) = _dr_maps_z2(w, h, angle, 0, 0)
            abj = jnp.asarray(np.asarray(a_base).reshape(-1) + 1)
            asj = jnp.asarray(np.asarray(a_shift).reshape(-1))
            va = (ab_ext[:, abj] * (32 - asj) + ab_ext[:, abj + 1] * asj +
                  16) >> 5
            lbj = jnp.asarray(np.asarray(l_base).reshape(-1) + 2)
            lsj = jnp.asarray(np.asarray(l_shift).reshape(-1))
            vl = (le_ext[:, lbj] * (32 - lsj) + le_ext[:, lbj + 1] * lsj +
                  16) >> 5
            v = jnp.where(jnp.asarray(np.asarray(use_above).reshape(-1)),
                          va, vl)
        else:
            base, shift, _ = _dr_maps_z3(w, h, angle, 0)
            max_base = w + h - 1
            b = np.minimum(np.asarray(base), max_base)
            bj = jnp.asarray(b.reshape(-1) + 2)
            sj = jnp.asarray(np.broadcast_to(np.asarray(shift),
                                             (h, w)).reshape(-1))
            v = (le_ext[:, bj] * (32 - sj) + le_ext[:, bj + 1] * sj +
                 16) >> 5
            mask = jnp.asarray((np.asarray(base) < max_base).reshape(-1))
            v = jnp.where(mask, v, le_ext[:, max_base + 2][:, None])
        outs.append(jnp.clip(v, 0, hi).reshape(n, h, w))
    return jnp.stack(outs, axis=1)


def block_mode_costs(plane: jnp.ndarray, size: int, bd: int = 8):
    """Open-loop mode-search SAD for every size×size block of a plane.

    plane dims must be multiples of size. Returns (costs (nr, nc, n_modes),
    best (nr, nc)). Source-edge approximation (commit re-predicts exactly)."""
    H, W = plane.shape
    p = plane.astype(jnp.int32)
    above, left, al, ha, hl = _gather_sb_edges(p, size, bd)
    n = above.shape[0]
    preds = predict_modes_batch(above, left, al, ha, hl, size, size, bd)
    blocks = p.reshape(H // size, size, W // size, size).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(n, 1, size, size)
    sad = jnp.abs(blocks - preds).sum(axis=(2, 3))
    nr, nc = H // size, W // size
    return (sad.reshape(nr, nc, -1),
            jnp.argmin(sad, axis=1).reshape(nr, nc))


def _gather_sb_edges(plane: jnp.ndarray, sb: int, bd: int,
                     ext: bool = False):
    """Edges for every SB of a plane from the SOURCE frame (open-loop search
    approximation — commit re-predicts from recon). plane: (H, W) int32.
    Returns (above (N,sb), left (N,sb), above_left (N,), have_a, have_l)
    plus (above2 (N,2sb), left2 (N,2sb)) extended edges when ext=True
    (above-right / below-left continuation, clamped at the frame edge)."""
    H, W = plane.shape
    nr, nc = H // sb, W // sb
    base = 1 << (bd - 1)
    padded = jnp.pad(plane, ((1, 0), (1, 0)), constant_values=base)
    # above rows: padded[r*sb, c*sb+1 : +sb]
    rows = padded[::sb, :][:nr, 1:]                     # (nr, W)
    above = rows.reshape(nr, nc, sb)                    # (nr, nc, sb)
    cols = padded[:, ::sb][1:, :nc]                     # (H, nc)
    left = cols.reshape(nr, sb, nc).transpose(0, 2, 1)  # (nr, nc, sb)
    al = padded[::sb, ::sb][:nr, :nc]                   # (nr, nc)
    have_a = jnp.broadcast_to(
        (jnp.arange(nr) > 0).reshape(nr, 1), (nr, nc))
    have_l = jnp.broadcast_to(
        (jnp.arange(nc) > 0).reshape(1, nc), (nr, nc))
    n = nr * nc
    # spec edge fill for unavailable sides
    above = jnp.where(have_a.reshape(nr, nc, 1), above,
                      jnp.where(have_l.reshape(nr, nc, 1),
                                left[:, :, :1], base - 1))
    left = jnp.where(have_l.reshape(nr, nc, 1), left,
                     jnp.where(have_a.reshape(nr, nc, 1),
                               above[:, :, :1], base + 1))
    out = (above.reshape(n, sb), left.reshape(n, sb), al.reshape(n),
           have_a.reshape(n), have_l.reshape(n))
    if not ext:
        return out
    # extended edges: 2*sb along each side, clamped at frame bounds
    cs = jnp.arange(2 * sb)
    xs = jnp.minimum(jnp.arange(nc).reshape(nc, 1) * sb + cs, W - 1)
    above2 = rows[:, xs]                         # (nr, nc, 2sb)
    ys = jnp.minimum(jnp.arange(nr).reshape(nr, 1) * sb + cs, H - 1)
    left2 = cols.T[:, ys].transpose(1, 0, 2)     # (nr, nc, 2sb)
    above2 = jnp.where(have_a.reshape(nr, nc, 1), above2,
                       jnp.where(have_l.reshape(nr, nc, 1),
                                 left[:, :, :1], base - 1))
    left2 = jnp.where(have_l.reshape(nr, nc, 1), left2,
                      jnp.where(have_a.reshape(nr, nc, 1),
                                above[:, :, :1], base + 1))
    return out + (above2.reshape(n, 2 * sb), left2.reshape(n, 2 * sb))


N_CANDS = 3


def intra_decide(plane_u8: jnp.ndarray, split_bias: jnp.ndarray,
                 bd: int = 8, min_block: int = 8):
    """Fused device decision stage: mode search at every size + split tree.

    One jitted call per frame.
    plane_u8: (H, W) uint8/uint16 padded source luma; split_bias: scalar
    int32 (rate bias per split, q-dependent). Returns
    (split64, split32, split16, mode64, mode32, mode16, mode8) — split maps
    uint8 (nr, nc); mode maps uint8 (nr, nc, N_CANDS) top-K candidates for
    the host RD trial. Mirrors the reference's staged MD: dense stage-0
    cost here, full RD on the top-K downstream (ref: mode_decision.c
    md_stage_0 -> md_stage_3)."""
    p = plane_u8.astype(jnp.int32)
    H, W = p.shape
    mode_lut = jnp.asarray(SEARCH_MODE_ORDER, jnp.uint8)
    sizes = [s for s in (64, 32, 16, 8) if s >= min_block]
    costs = {}
    modes = {}
    for s in sizes:
        a, l, c0, da, dl, a2, l2 = _gather_sb_edges(p, s, bd, ext=True)
        preds = predict_modes_batch(a, l, c0, da, dl, s, s, bd)
        dpreds = predict_directional_batch(a2, l2, c0, s, bd)
        preds = jnp.concatenate([preds, dpreds], axis=1)
        blocks = p.reshape(H // s, s, W // s, s).transpose(0, 2, 1, 3)
        n = blocks.shape[0] * blocks.shape[1]
        sad = jnp.abs(blocks.reshape(n, 1, s, s) - preds).sum(axis=(2, 3))
        # split decisions use the non-directional cost floor: directional
        # SAD on source edges overfits noise at large sizes (the commit
        # pass predicts from quantized recon), biasing the tree shallow
        costs[s] = jnp.min(sad[:, :7], axis=1).reshape(H // s, W // s)
        # order on (SAD, mode index): a total order, so every backend
        # keeps the same candidates on ties (SAD < 2^24 up to 12 bits)
        key = sad * 16 + jnp.arange(sad.shape[1], dtype=jnp.int32)
        topk = jnp.argsort(key, axis=1)[:, :N_CANDS]
        modes[s] = mode_lut[topk].reshape(H // s, W // s, N_CANDS)
    for s in (64, 32, 16, 8):
        if s not in modes:
            modes[s] = jnp.zeros((H // s, W // s, N_CANDS), jnp.uint8)
    split = {s: jnp.zeros((H // s, W // s), jnp.uint8) for s in (64, 32, 16)}
    if len(sizes) > 1:
        eff = {sizes[-1]: costs[sizes[-1]]}
        for s in sizes[-2::-1]:
            child = eff[s // 2]
            agg = (child[0::2, 0::2] + child[0::2, 1::2] +
                   child[1::2, 0::2] + child[1::2, 1::2])
            do_split = agg + split_bias < costs[s]
            split[s] = do_split.astype(jnp.uint8)
            eff[s] = jnp.where(do_split, agg + split_bias, costs[s])
    return (split[64], split[32], split[16],
            modes[64], modes[32], modes[16], modes[8])


def intra_decide_packed(plane_u8: jnp.ndarray, split_bias: jnp.ndarray,
                        bd: int = 8, min_block: int = 8):
    """intra_decide with all seven outputs packed into ONE uint8 vector.

    Packing split + mode maps into a single buffer makes the per-frame
    result exactly one device->host transfer, which the encode pipeline
    starts asynchronously at dispatch time (fast_intra.py
    prefetch_decide) so it rides under the host commit walk. The packing
    was chosen for a transport with a large fixed cost per fetched array;
    ROADMAP A6 measures whether it still pays on the GPU."""
    outs = intra_decide(plane_u8, split_bias, bd, min_block)
    return jnp.concatenate([o.reshape(-1).astype(jnp.uint8) for o in outs])


def intra_decide_unpack(buf, shape):
    """Host-side unpack of intra_decide_packed (numpy). shape = padded
    (H, W) of the plane the program ran on."""
    import numpy as np

    H, W = shape
    parts = []
    off = 0
    for s in (64, 32, 16):
        n = (H // s) * (W // s)
        parts.append(buf[off:off + n].reshape(H // s, W // s))
        off += n
    for s in (64, 32, 16, 8):
        n = (H // s) * (W // s) * N_CANDS
        parts.append(buf[off:off + n].reshape(H // s, W // s, N_CANDS))
        off += n
    assert off == buf.size
    return tuple(parts)


def pack_mv_sad(mv16: jnp.ndarray, sad: jnp.ndarray):
    """Pack a full-pel ME result (mv16, sad16) into ONE int32 vector
    (same latency rationale as intra_decide_packed)."""
    return jnp.concatenate([mv16.reshape(-1).astype(jnp.int32),
                            sad.reshape(-1).astype(jnp.int32)])


def hme2_unpack(buf, n16r, n16c):
    import numpy as np

    nmv = n16r * n16c * 2
    mv16 = buf[:nmv].reshape(n16r, n16c, 2).astype(np.int16)
    sad = buf[nmv:].reshape(n16r, n16c)
    return mv16, sad


def hme_search(src_u8: jnp.ndarray, ref_u8: jnp.ndarray,
               search_range: int = 12):
    """Open-loop hierarchical ME: full-pel MV per 16x16 block.

    The reference's HME pyramid (ref: motion_estimation.c hme_level_0/1/2)
    as one dense device program: search at half resolution over
    +-search_range (full-res +-2*search_range) with a fori running-min
    over the offset grid, returning (mv16 (n16r, n16c, 2) int16 full-pel,
    sad16 (n16r, n16c) int32). The host walk polishes with a +-fullpel /
    subpel diamond (inter_backend.c)."""
    import jax

    H, W = src_u8.shape
    src = src_u8.astype(jnp.int32)
    ref = ref_u8.astype(jnp.int32)
    # half-res decimation (average pool)
    sh = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] +
          src[1::2, 1::2] + 2) >> 2
    rh = (ref[0::2, 0::2] + ref[0::2, 1::2] + ref[1::2, 0::2] +
          ref[1::2, 1::2] + 2) >> 2
    Hh, Wh = H // 2, W // 2
    n16r, n16c = Hh // 8, Wh // 8
    R = search_range
    rp = jnp.pad(rh, ((R, R), (R, R)), mode="edge")
    side = 2 * R + 1

    def body(i, carry):
        best_sad, best_mv = carry
        dy = i // side - R
        dx = i % side - R
        shifted = jax.lax.dynamic_slice(rp, (dy + R, dx + R), (Hh, Wh))
        d = jnp.abs(sh - shifted)
        sad = d.reshape(n16r, 8, n16c, 8).sum(axis=(1, 3))
        better = sad < best_sad
        best_mv = jnp.where(better[..., None],
                            jnp.stack([jnp.full((n16r, n16c), dy),
                                       jnp.full((n16r, n16c), dx)],
                                      axis=-1), best_mv)
        best_sad = jnp.where(better, sad, best_sad)
        return best_sad, best_mv

    init = (jnp.full((n16r, n16c), 1 << 30, jnp.int32),
            jnp.zeros((n16r, n16c, 2), jnp.int32))
    best_sad, best_mv = jax.lax.fori_loop(0, side * side, body, init)
    return (2 * best_mv).astype(jnp.int16), best_sad


def hme_search2(src_u8: jnp.ndarray, ref_u8: jnp.ndarray,
                r0: int = 16, r1: int = 7):
    """Two-level hierarchical full-pel ME: quarter-res pre-search seeds a
    per-block half-res refinement (the reference's hme_level_0 -> 1/2
    funnel, ref motion_estimation.c:820-1025, as two dense device
    stages). Reach is +-(4*r0 + 2*r1) full-pel (+-78 at defaults) vs
    hme_search's +-2*search_range — needed for long-distance ARF
    references in the random-access pyramid (4 px/frame motion over a
    16-frame mini-GoP is +-64 px).

    Returns (mv16 (n16r, n16c, 2) int16 full-pel, sad16 (n16r, n16c)
    int32 half-res 8x8 SAD) — same contract as hme_search."""
    import jax

    H, W = src_u8.shape
    src = src_u8.astype(jnp.int32)
    ref = ref_u8.astype(jnp.int32)
    sh = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] +
          src[1::2, 1::2] + 2) >> 2
    rh = (ref[0::2, 0::2] + ref[0::2, 1::2] + ref[1::2, 0::2] +
          ref[1::2, 1::2] + 2) >> 2
    sq = (sh[0::2, 0::2] + sh[0::2, 1::2] + sh[1::2, 0::2] +
          sh[1::2, 1::2] + 2) >> 2
    rq = (rh[0::2, 0::2] + rh[0::2, 1::2] + rh[1::2, 0::2] +
          rh[1::2, 1::2] + 2) >> 2
    Hh, Wh = H // 2, W // 2
    Hq, Wq = H // 4, W // 4
    n16r, n16c = Hh // 8, Wh // 8          # 16x16 full-res blocks

    # level 0: quarter-res plane-shift SAD over +-r0, one 4x4 block per
    # 16x16 full-res block. The dx axis is unrolled STATICALLY into a
    # stacked tensor so each of the (2*r0+1) sequential dy steps does
    # (2*r0+1) * Hq * Wq of vector work — a flat fori over all
    # (2*r0+1)^2 offsets runs tiny per-step slices (ROADMAP A5 measures
    # the choice on the GPU).
    rp0 = jnp.pad(rq, ((r0, r0), (r0, r0)), mode="edge")
    side0 = 2 * r0 + 1
    # (side0, Hq + 2*r0, Wq): all static x-shifts
    xshift0 = jnp.stack([rp0[:, k:k + Wq] for k in range(side0)])

    def body0(i, carry):
        best_sad, best_mv = carry
        dy = i - r0
        sh_rows = jax.lax.dynamic_slice(
            xshift0, (0, i, 0), (side0, Hq, Wq))      # (side0, Hq, Wq)
        d = jnp.abs(sq[None] - sh_rows)
        sad = d.reshape(side0, n16r, 4, n16c, 4).sum(axis=(2, 4))
        k = jnp.argmin(sad, axis=0)                   # (n16r, n16c)
        s_min = jnp.min(sad, axis=0)
        better = s_min < best_sad
        cand_mv = jnp.stack([jnp.full((n16r, n16c), dy),
                             k.astype(jnp.int32) - r0], axis=-1)
        best_mv = jnp.where(better[..., None], cand_mv, best_mv)
        best_sad = jnp.where(better, s_min, best_sad)
        return best_sad, best_mv

    init0 = (jnp.full((n16r, n16c), 1 << 30, jnp.int32),
             jnp.zeros((n16r, n16c, 2), jnp.int32))
    _, seed_q = jax.lax.fori_loop(0, side0, body0, init0)

    # global seed candidates: top-K most-voted level-0 MVs across the
    # frame (the reference's HME candidate injection role). A block
    # whose own seed tracked the majority motion of its 16x16 area
    # still gets refined around the frame's other dominant motions —
    # wrap-around scroll bands, occlusion-reveal areas and small
    # regions moving against a pan need exactly the second/third
    # global mode (ref motion_estimation.c hme candidate seeding).
    import os
    K_GLOB = int(os.environ.get("SVT_HME_GLOBK", "4"))
    seed_flat = seed_q.reshape(-1, 2)
    if K_GLOB:
        nv = side0 * side0
        vote_idx = (seed_flat[:, 0] + r0) * side0 + (seed_flat[:, 1] + r0)
        # histogram as a one-hot reduction instead of a scatter-add
        # (ROADMAP A5 measures the choice on the GPU)
        votes = (vote_idx[:, None] ==
                 jnp.arange(nv, dtype=jnp.int32)[None, :]) \
            .sum(axis=0, dtype=jnp.int32)
        # rank on (votes, then lower MV index): a total order, so every
        # backend picks the same modes on tied counts
        rank = votes * nv + (nv - 1 - jnp.arange(nv, dtype=jnp.int32))
        _, top_idx = jax.lax.top_k(rank, K_GLOB)
        glob_mv = jnp.stack([top_idx // side0 - r0, top_idx % side0 - r0],
                            axis=-1)                    # (K_GLOB, 2)

    # level 1: half-res per-block window refinement +-r1 around 2*seed
    P = 2 * r0 + r1 + 8
    rp1 = jnp.pad(rh, ((P, P), (P, P)), mode="edge")
    wsz = 8 + 2 * r1
    nb = n16r * n16c
    bi = jnp.arange(nb)
    by = bi // n16c
    bx = bi % n16c
    blks = sh.reshape(n16r, 8, n16c, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    side1 = 2 * r1 + 1
    cy = by * 8 + 2 * seed_flat[:, 0] - r1 + P
    cx = bx * 8 + 2 * seed_flat[:, 1] - r1 + P

    def get_win(y0, x0):
        return jax.lax.dynamic_slice(rp1, (y0, x0), (wsz, wsz))

    wins = jax.vmap(get_win)(cy, cx)                    # (n, wsz, wsz)
    # static dx unroll (same rationale as level 0): (side1, n, wsz, 8)
    winx = jnp.stack([wins[:, :, k:k + 8] for k in range(side1)])

    def body1(dy, carry):
        best_sad, best_off = carry
        win = jax.lax.dynamic_slice(
            winx, (0, 0, dy, 0), (side1, winx.shape[1], 8, 8))
        sad = jnp.abs(win - blks[None]).sum(axis=(2, 3))  # (side1, n)
        k = jnp.argmin(sad, axis=0)
        s_min = jnp.min(sad, axis=0)
        better = s_min < best_sad
        off = jnp.stack([jnp.full((nb,), dy - r1),
                         k.astype(jnp.int32) - r1], axis=-1)
        best_off = jnp.where(better[:, None], off, best_off)
        best_sad = jnp.where(better, s_min, best_sad)
        return best_sad, best_off

    init1 = (jnp.full((nb,), 1 << 30, jnp.int32),
             jnp.zeros((nb, 2), jnp.int32))
    best_sad, best_off = jax.lax.fori_loop(0, side1, body1, init1)
    mv_h = 2 * seed_flat + best_off                     # half-res units
    best_sad = best_sad.reshape(n16r, n16c)
    mv_h = mv_h.reshape(n16r, n16c, 2)

    # global candidates refined DENSELY (plane shifts like level 0,
    # instead of a per-candidate gather refine): each of the K_GLOB
    # frame-dominant MV
    # modes gets a small +-R1G half-res window evaluated as whole-plane
    # shifts with per-8x8 box sums; a block whose own-seed refinement
    # lost to a global mode (wrap-around scroll bands, occlusion
    # reveals, counter-pan objects) takes the global MV.
    R1G = 2
    Hh2, Wh2 = n16r * 8, n16c * 8
    shc = sh[:Hh2, :Wh2]
    sideg = 2 * R1G + 1

    def bodyg(t, carry):
        # one (candidate, dy) pair per sequential step; the dx axis is
        # unrolled statically inside a single dynamic window slice
        # (same rationale as level 0)
        best_sad2, best_mv2 = carry
        k = t // sideg
        dy = t % sideg - R1G
        oy = 2 * glob_mv[k, 0] + dy
        ox0 = 2 * glob_mv[k, 1] - R1G
        win = jax.lax.dynamic_slice(rp1, (oy + P, ox0 + P),
                                    (Hh2, Wh2 + sideg - 1))
        d = jnp.stack([jnp.abs(shc - win[:, j:j + Wh2])
                       for j in range(sideg)])
        sad = d.reshape(sideg, n16r, 8, n16c, 8).sum(axis=(2, 4))
        j = jnp.argmin(sad, axis=0)
        s_min = jnp.min(sad, axis=0)
        better = s_min < best_sad2
        mv2 = jnp.stack([jnp.full((n16r, n16c), oy),
                         ox0 + j.astype(jnp.int32)], axis=-1)
        best_mv2 = jnp.where(better[..., None], mv2, best_mv2)
        best_sad2 = jnp.where(better, s_min, best_sad2)
        return best_sad2, best_mv2

    if K_GLOB:
        best_sad, mv_h = jax.lax.fori_loop(0, K_GLOB * sideg,
                                           bodyg, (best_sad, mv_h))
    mv16 = (2 * mv_h).reshape(n16r, n16c, 2).astype(jnp.int16)
    return mv16, best_sad.reshape(n16r, n16c)


def _gather_sad_nodes(sh, rh, off, bs, pad):
    """Half-res SAD of every bs x bs node of `sh` against `rh` shifted
    by the per-node offset map `off` (half-res units, (nr, nc, 2)).
    `rh` must already be edge-padded by `pad` on every side (offsets
    are clamped into it). Implemented as a vmap of dynamic_slice per
    node rather than a full-plane 2-D gather (ROADMAP A5 measures the
    choice on the GPU). Returns (nr, nc) int32."""
    import jax

    nr, nc = off.shape[:2]
    blocks = sh[:nr * bs, :nc * bs].reshape(nr, bs, nc, bs) \
        .transpose(0, 2, 1, 3).reshape(-1, bs, bs)
    oy = jnp.clip(off[..., 0].reshape(-1), -pad, pad)
    ox = jnp.clip(off[..., 1].reshape(-1), -pad, pad)
    bi = jnp.arange(nr * nc)
    y0 = (bi // nc) * bs + oy + pad
    x0 = (bi % nc) * bs + ox + pad

    def one(y, x):
        return jax.lax.dynamic_slice(rh, (y, x), (bs, bs))

    wins = jax.vmap(one)(y0, x0)
    return jnp.abs(wins - blocks).sum(axis=(1, 2)).reshape(nr, nc)


def hme_sad_tree(src_u8: jnp.ndarray, ref_u8: jnp.ndarray,
                 mv16: jnp.ndarray):
    """The open-loop fullpel SAD tree above 16x16 (ref
    motion_estimation.c open_loop_me_fullpel_search_sblock:781 — the
    reference's ME produces SADs for the whole 8x8..64x64 block tree;
    here the 32- and 64-levels, each node evaluated at its children's
    winning MVs and taking the best single MV). Feeds the inter
    partition-tree decisions (models/inter_tree.py): a node whose best
    single-MV SAD is close to its children's sum gains nothing from
    splitting.

    mv16: (n16r, n16c, 2) int full-pel (even values — half-res grid).
    Returns (sad32 (n32r, n32c), sad64 (n64r, n64c)) int32 half-res
    SADs."""
    src = src_u8.astype(jnp.int32)
    ref = ref_u8.astype(jnp.int32)
    sh = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] +
          src[1::2, 1::2] + 2) >> 2
    rh = (ref[0::2, 0::2] + ref[0::2, 1::2] + ref[1::2, 0::2] +
          ref[1::2, 1::2] + 2) >> 2
    PAD = 48                                     # >= hme_search2 reach/2
    rhp = jnp.pad(rh, ((PAD, PAD), (PAD, PAD)), mode="edge")
    mvh = (mv16.astype(jnp.int32) >> 1)          # half-res units
    n16r, n16c = mvh.shape[:2]
    n32r, n32c = n16r // 2, n16c // 2

    def level(off_child, bs):
        """off_child: (2nr, 2nc, 2) child offsets; evaluate each of the
        4 child MVs over the whole parent node."""
        best = None
        best_off = None
        for i in (0, 1):
            for j in (0, 1):
                off = off_child[i::2, j::2]
                sad = _gather_sad_nodes(sh, rhp, off, bs, PAD)
                if best is None:
                    best, best_off = sad, off
                else:
                    take = sad < best
                    best_off = jnp.where(take[..., None], off, best_off)
                    best = jnp.minimum(best, sad)
        return best, best_off

    sad32, mv32 = level(mvh, 16)
    sad64, _ = level(mv32, 32)
    return sad32, sad64


def gop_search(frames_u8: jnp.ndarray, edges: jnp.ndarray,
               split_bias: jnp.ndarray, bd: int = 8, min_block: int = 8):
    """GoP-batched device search: one program for a whole mini-GoP.

    The device batching of the reference's per-picture ME/PA process
    fan-out (ref me_process.c:97 — N ME kernels run concurrently on
    different pictures; SURVEY.md §2.2 P2): every frame's intra decision
    maps and every prediction edge's hierarchical full-pel ME run as ONE
    jitted program over the frame axis, so the encoder pays exactly one
    dispatch + one device->host transfer per mini-GoP instead of 2-3 per
    frame.

    frames_u8: (F, H, W) stacked padded source lumas (entry 0 may be the
    previous anchor's recon). edges: (E, 2) int32 (src_idx, ref_idx)
    prediction edges in frames_u8 indexing; padding edges (0, 0) are
    computed and ignored by the host. Returns one uint8 vector:
    [bitcast int32 mv (E,n16r,n16c,2) | bitcast int32 sad (E,n16r,n16c) |
     per-frame intra_decide_packed buffers (F, dsz)]."""
    F, H, W = frames_u8.shape

    # lax.map, NOT vmap: one frame's decide holds a (blocks, 13, 64,
    # 64) prediction tensor (~100 MB at 1080p); batching F frames
    # multiplies it (ROADMAP A5 measures the choice on the GPU).
    dec = jax.lax.map(
        lambda f: intra_decide_packed(f, split_bias, bd, min_block),
        frames_u8)

    def one_edge(e):
        mv, sad = hme_search2(frames_u8[e[0]], frames_u8[e[1]])
        # fullpel SAD tree above 16x16 (ref open-loop ME tree): feeds
        # the inter partition decisions without extra dispatches
        s32, s64 = hme_sad_tree(frames_u8[e[0]], frames_u8[e[1]], mv)
        return mv, sad, s32, s64

    # chunked vmap: the restructured HME holds multi-10MB static shift
    # stacks per edge, so a full-width vmap over ~3*M edges multiplies
    # them into gigabytes of device-memory traffic, while a pure
    # sequential lax.map leaves batching efficiency on the table. The
    # chunk of eight edges is ROADMAP A5's to measure on the GPU.
    E = edges.shape[0]
    CH = 8
    pad_e = (-E) % CH
    edges_p = jnp.concatenate(
        [edges, jnp.zeros((pad_e, 2), edges.dtype)]) if pad_e else edges
    outs = jax.lax.map(lambda ch: jax.vmap(one_edge)(ch),
                       edges_p.reshape(-1, CH, 2))
    mv, sad, s32, s64 = [o.reshape((-1,) + o.shape[2:])[:E]
                         for o in outs]
    mvsad = jnp.concatenate([mv.astype(jnp.int32).reshape(-1),
                             sad.astype(jnp.int32).reshape(-1),
                             s32.astype(jnp.int32).reshape(-1),
                             s64.astype(jnp.int32).reshape(-1)])
    mvsad_u8 = jax.lax.bitcast_convert_type(mvsad, jnp.uint8).reshape(-1)
    return jnp.concatenate([mvsad_u8, dec.reshape(-1)])


def gop_search_unpack(buf: np.ndarray, n_frames: int, n_edges: int,
                      shape):
    """Host-side unpack of gop_search. shape = padded (H, W).

    Returns (mv (E, n16r, n16c, 2) int16 full-pel,
             sad (E, n16r, n16c) int32,
             sad32 (E, n32r, n32c) int32, sad64 (E, n64r, n64c) int32,
             decide (F, dsz) uint8 rows for intra_decide_unpack)."""
    H, W = shape
    n16r, n16c = H // 16, W // 16
    n16 = n16r * n16c
    nmv = n_edges * n16 * 2
    nsad = n_edges * n16
    n32 = n_edges * (n16 // 4)
    n64 = n_edges * (n16 // 16)
    tot = nmv + nsad + n32 + n64
    ints = np.frombuffer(buf[:4 * tot].tobytes(), np.int32)
    mv = ints[:nmv].reshape(n_edges, n16r, n16c, 2).astype(np.int16)
    sad = ints[nmv:nmv + nsad].reshape(n_edges, n16r, n16c).copy()
    sad32 = ints[nmv + nsad:nmv + nsad + n32].reshape(
        n_edges, n16r // 2, n16c // 2).copy()
    sad64 = ints[nmv + nsad + n32:tot].reshape(
        n_edges, n16r // 4, n16c // 4).copy()
    dec = buf[4 * tot:].reshape(n_frames, -1)
    return mv, sad, sad32, sad64, dec


def _tf_align(center: jnp.ndarray, neigh: jnp.ndarray, mv16: jnp.ndarray,
              sub: int):
    """MC alignment of `neigh` onto `center` with per-16x16 (luma
    units) full-pel MVs — the device analog of
    models/temporal_filter._align_plane. center/neigh: (H, W) int32;
    mv16: (n16r, n16c, 2) int32. Per-block dynamic_slice of an
    edge-padded plane rather than a full-plane 2-D gather (ROADMAP A5
    measures the choice on the GPU). Returns
    (aligned (H, W) int32, per-block mean-SSE (n16r, n16c) float32)."""
    import jax

    H, W = center.shape
    bs = 16 >> sub
    n16r, n16c = mv16.shape[:2]
    PAD = 96 >> sub          # >= hme_search2 full-pel reach (+-82)
    np_pad = jnp.pad(neigh, ((PAD, PAD), (PAD, PAD)), mode="edge")
    oy = jnp.clip(mv16[..., 0] >> sub, -PAD, PAD).reshape(-1)
    ox = jnp.clip(mv16[..., 1] >> sub, -PAD, PAD).reshape(-1)
    bi = jnp.arange(n16r * n16c)
    y0 = (bi // n16c) * bs + oy + PAD
    x0 = (bi % n16c) * bs + ox + PAD

    def one(y, x):
        return jax.lax.dynamic_slice(np_pad, (y, x), (bs, bs))

    wins = jax.vmap(one)(y0, x0)                 # (n, bs, bs)
    out = wins.reshape(n16r, n16c, bs, bs).transpose(0, 2, 1, 3) \
        .reshape(n16r * bs, n16c * bs)
    if out.shape != (H, W):
        out = jnp.pad(out, ((0, H - out.shape[0]), (0, W - out.shape[1])),
                      mode="edge")
    d2 = (out - center).astype(jnp.float32) ** 2
    err = d2[:n16r * bs, :n16c * bs].reshape(n16r, bs, n16c, bs) \
        .mean(axis=(1, 3))
    return out, err


def tf_filter_device(win_y: jnp.ndarray, win_u: jnp.ndarray,
                     win_v: jnp.ndarray, win_mask: jnp.ndarray,
                     strength: jnp.ndarray, bd: int = 8):
    """Device temporal filter: models/temporal_filter.temporal_filter as
    one fused program (ref temporal_filtering.c:1021 medium planewise
    filter). win_y: (T, H, W) window lumas, center LAST; win_u/win_v:
    (T, Hc, Wc) chromas; win_mask: (T,) float32 (0 = padding slot, the
    center slot must be 1; a masked slot contributes nothing). Returns
    filtered (y, u, v) planes, int32 in [0, 2^bd)."""
    T, H, W = win_y.shape
    wy = win_y.astype(jnp.int32)
    wu = win_u.astype(jnp.int32)
    wv = win_v.astype(jnp.int32)
    cy, cu, cv = wy[T - 1], wu[T - 1], wv[T - 1]
    sigma2 = jnp.maximum(
        4.0, jnp.var(jnp.diff(cy, axis=1).astype(jnp.float32)) / 8.0)
    inv = 1.0 / (sigma2 * (1.0 + strength.astype(jnp.float32)))
    acc_y = cy.astype(jnp.float32)
    acc_u = cu.astype(jnp.float32)
    acc_v = cv.astype(jnp.float32)
    wt_y = jnp.ones((H, W), jnp.float32)
    wt_c = jnp.ones(cu.shape, jnp.float32)
    for i in range(T - 1):
        mv16, _ = hme_search2(wy[T - 1], wy[i])
        mv16 = mv16.astype(jnp.int32)
        ay, err = _tf_align(cy, wy[i], mv16, 0)
        # NOTE a percentile noise-floor subtraction (err - P25(err)) was
        # tried here to reach sqrt(T) denoising on static content; it
        # regressed pan-class BD ~1 dB — on all-motion content the
        # floor absorbs real subpel misalignment error and over-blends.
        w_blk = jnp.exp(-err * inv)
        w_blk = jnp.where(err > 16.0 * sigma2, 0.0, w_blk) * win_mask[i]
        w_px = jnp.repeat(jnp.repeat(w_blk, 16, 0), 16, 1)[:H, :W]
        acc_y += w_px * ay
        wt_y += w_px
        au, _ = _tf_align(cu, wu[i], mv16, 1)
        av, _ = _tf_align(cv, wv[i], mv16, 1)
        w_pc = jnp.repeat(jnp.repeat(w_blk, 8, 0),
                          8, 1)[:cu.shape[0], :cu.shape[1]]
        acc_u += w_pc * au
        acc_v += w_pc * av
        wt_c += w_pc
    hi = (1 << bd) - 1
    fy = jnp.clip(jnp.rint(acc_y / wt_y), 0, hi).astype(jnp.int32)
    fu = jnp.clip(jnp.rint(acc_u / wt_c), 0, hi).astype(jnp.int32)
    fv = jnp.clip(jnp.rint(acc_v / wt_c), 0, hi).astype(jnp.int32)
    return fy, fu, fv


def gop_search_tf(frames_u8: jnp.ndarray, edges: jnp.ndarray,
                  split_bias: jnp.ndarray, win_u: jnp.ndarray,
                  win_v: jnp.ndarray, win_idx: jnp.ndarray,
                  win_mask: jnp.ndarray, strength: jnp.ndarray,
                  bd: int = 8, min_block: int = 8,
                  win2_u: jnp.ndarray = None, win2_v: jnp.ndarray = None,
                  win2_idx: jnp.ndarray = None,
                  win2_mask: jnp.ndarray = None):
    """gop_search with the anchor temporal filters fused in: the window
    lumas are gathered from the frame stack (win_idx, center = the ARF
    at stack position 1), filtered on device, and the FILTERED planes
    replace their stack entries before the decide/HME phase — so the
    whole mini-GoP costs one dispatch and one packed transfer including
    the TF (the reference runs TF as a separate host pass,
    ref temporal_filtering.c:4064). When win2_* is given, the depth-1
    mid anchor (stack position 2) filters too with a +-2 window — the
    reference also TFs its layer-1 pictures (tf_params_per_type[1]).

    win_u/win_v: (T, Hc, Wc) chroma planes of the window frames (same
    order as win_idx; the luma comes from frames_u8[win_idx]).
    Returns one uint8 vector:
    [gop_search payload | ARF y u v | (mid y u v) (u8/u16 bitcast)]."""
    dtype = frames_u8.dtype
    win_y = frames_u8[win_idx].astype(jnp.int32)
    fy, fu, fv = tf_filter_device(win_y, win_u, win_v, win_mask,
                                  strength, bd)
    frames_f = frames_u8.at[1].set(fy.astype(dtype))
    parts = [fy.reshape(-1), fu.reshape(-1), fv.reshape(-1)]
    if win2_idx is not None:
        win2_y = frames_u8[win2_idx].astype(jnp.int32)
        f2y, f2u, f2v = tf_filter_device(win2_y, win2_u, win2_v,
                                         win2_mask, strength, bd)
        frames_f = frames_f.at[2].set(f2y.astype(dtype))
        parts += [f2y.reshape(-1), f2u.reshape(-1), f2v.reshape(-1)]
    main = gop_search(frames_f, edges, split_bias, bd, min_block)
    planes = jnp.concatenate(parts)
    if bd == 8:
        planes_u8 = planes.astype(jnp.uint8)
    else:
        planes_u8 = jax.lax.bitcast_convert_type(
            planes.astype(jnp.uint16), jnp.uint8).reshape(-1)
    return jnp.concatenate([main, planes_u8])


def gop_search_tf_unpack(buf: np.ndarray, n_frames: int, n_edges: int,
                         shape, bd: int = 8, n_filtered: int = 1):
    """Host-side unpack of gop_search_tf: returns (mv, sad, sad32,
    sad64, dec, [(fy, fu, fv), ...]) where the first five match
    gop_search_unpack and each filtered anchor's planes are
    uint8/uint16 (H, W) / (Hc, Wc). n_filtered: 1 = ARF only,
    2 = ARF + depth-1 mid."""
    H, W = shape
    hc, wc = H // 2, W // 2
    npl = H * W + 2 * hc * wc
    nbytes = n_filtered * npl * (1 if bd == 8 else 2)
    mv, sad, sad32, sad64, dec = gop_search_unpack(
        buf[:-nbytes], n_frames, n_edges, shape)
    tail = buf[-nbytes:]
    if bd == 8:
        pl = tail
    else:
        pl = np.frombuffer(tail.tobytes(), np.uint16)
    out = []
    for k in range(n_filtered):
        o = k * npl
        fy = pl[o:o + H * W].reshape(H, W)
        fu = pl[o + H * W:o + H * W + hc * wc].reshape(hc, wc)
        fv = pl[o + H * W + hc * wc:o + npl].reshape(hc, wc)
        out.append((fy, fu, fv))
    return mv, sad, sad32, sad64, dec, out


def sb_mode_costs(plane: jnp.ndarray, sb: int = 64, bd: int = 8):
    """Open-loop intra mode search costs for every SB of a plane.

    Returns (costs (N, n_modes) int32 SAD, best (N,) argmin index)."""
    H, W = plane.shape
    p = plane.astype(jnp.int32)
    above, left, al, ha, hl = _gather_sb_edges(p, sb, bd)
    n = above.shape[0]
    preds = predict_modes_batch(above, left, al, ha, hl, sb, sb, bd)
    blocks = p.reshape(H // sb, sb, W // sb, sb).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(n, 1, sb, sb)
    sad = jnp.abs(blocks - preds).sum(axis=(2, 3))
    return sad, jnp.argmin(sad, axis=1)
