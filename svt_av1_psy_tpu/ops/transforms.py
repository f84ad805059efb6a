"""AV1 forward/inverse transforms — spec-exact integer implementation.

The inverse path is decoder-NORMATIVE (spec 7.13.3): encoder recon must be
bit-exact with any conforming decoder or inter prediction drifts. The forward
path matches the reference encoder's integer transforms so coefficients live
in the standard AV1 coefficient domain (ref: Source/Lib/Codec/transforms.c,
inv_transforms.c).

Design: every 1-D butterfly network is DATA (constants/txfm_stages.npz,
extracted by tools/gen_txfm_stages.py) run by one generic vectorized
stage-machine. The same tables drive the numpy reference here, the batched
JAX path (ops/jax_backend.py) and the native C walk — each stage is two
gathers + fused elementwise integer math over a batch of blocks. This module
is the exact commit path.

Everything is batched: arrays carry leading batch dimensions.
"""

from __future__ import annotations

import functools
import math
import pathlib

import numpy as np

from svt_av1_psy_tpu.constants import TX_SIZE_HIGH, TX_SIZE_WIDE, TxType

_STAGES_NPZ = pathlib.Path(__file__).parent.parent / "constants" / "txfm_stages.npz"

COS_BIT_MIN = 10
INV_COS_BIT = 12
NEW_SQRT2 = 5793       # round(2^12 * sqrt(2))
NEW_INV_SQRT2 = 2896   # round(2^12 / sqrt(2))
NEW_SQRT2_BITS = 12

# Inverse shifts per TX size (ref inv_transforms.c:14-42; spec-derived).
INV_SHIFT = [
    (0, -4), (-1, -4), (-2, -4), (-2, -4), (-2, -4),   # 4x4..64x64
    (0, -4), (0, -4),                                   # 4x8, 8x4
    (-1, -4), (-1, -4), (-1, -4), (-1, -4),             # 8x16,16x8,16x32,32x16
    (-1, -4), (-1, -4),                                 # 32x64, 64x32
    (-1, -4), (-1, -4),                                 # 4x16, 16x4
    (-2, -4), (-2, -4), (-2, -4), (-2, -4),             # 8x32,32x8,16x64,64x16
]
# Forward shifts (ref transforms.h:26-45).
FWD_SHIFT = [
    (2, 0, 0), (2, -1, 0), (2, -2, 0), (2, -4, 0), (0, -2, -2),
    (2, -1, 0), (2, -1, 0),
    (2, -2, 0), (2, -2, 0), (2, -4, 0), (2, -4, 0),
    (0, -2, -2), (2, -4, -2),
    (2, -1, 0), (2, -1, 0),
    (2, -2, 0), (2, -2, 0), (0, -2, 0), (2, -4, 0),
]
# Forward cos bits [txw_idx][txh_idx] (ref transforms.h:46-49).
FWD_COS_BIT_COL = [
    [13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]]
FWD_COS_BIT_ROW = [
    [13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]]

# 1-D type of the (vertical, horizontal) component per TxType.
# 1-D types: 0=DCT, 1=ADST, 2=FLIPADST, 3=IDTX
VTX_TAB = [0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3]
HTX_TAB = [0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2]


@functools.lru_cache(maxsize=1)
def _stage_tables():
    with np.load(_STAGES_NPZ) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=8)
def cospi_arr(cos_bit: int) -> np.ndarray:
    """cospi[i] = round(2^cos_bit * cos(i*pi/128)) — spec constant."""
    i = np.arange(64)
    return np.round((1 << cos_bit) * np.cos(i * math.pi / 128)).astype(np.int64)


@functools.lru_cache(maxsize=8)
def sinpi_arr(cos_bit: int) -> np.ndarray:
    """sinpi[k] = round(2^cos_bit * (2*sqrt(2)/3) * sin(k*pi/9)) — spec constant."""
    k = np.arange(5)
    return np.round((1 << cos_bit) * (2 * math.sqrt(2) / 3)
                    * np.sin(k * math.pi / 9)).astype(np.int64)


def round_shift(x, bit):
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _round_shift_array(x, bit):
    """ref svt_av1_round_shift_array_c: bit>0 rounds right, bit<0 shifts left."""
    if bit == 0:
        return x
    if bit > 0:
        return round_shift(x, bit)
    return x << (-bit)


def _clamp_bits(x, bits, xp):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return xp.clip(x, lo, hi)


def _run_stages(x, name: str, cos_bit: int, clamp_bits, xp=np,
                wdtype=np.int64):
    """Run an extracted butterfly network. x: (..., N) integer array.

    wdtype: the working integer dtype. int64 for the numpy trusted path;
    int32 for the JAX path (products stay within int32 thanks to the
    normative stage-range clamps — the same bound the reference's AVX2
    int32 lanes rely on, ref: Source/Lib/ASM_AVX2 inv/fwd txfm)."""
    t = _stage_tables()
    n = int(t[f"{name}_nstages"])
    cospi = cospi_arr(cos_bit)
    half = wdtype(1 << (cos_bit - 1))
    for s in range(n):
        a = t[f"{name}_s{s}_a"]
        b = t[f"{name}_s{s}_b"]
        mode = t[f"{name}_s{s}_mode"].astype(bool)
        clamp = t[f"{name}_s{s}_clamp"].astype(bool)
        lw0 = t[f"{name}_s{s}_lw0"].astype(wdtype)
        lw1 = t[f"{name}_s{s}_lw1"].astype(wdtype)
        w0 = (t[f"{name}_s{s}_c0s"].astype(np.int64) *
              cospi[t[f"{name}_s{s}_c0i"]]).astype(wdtype)
        w1 = (t[f"{name}_s{s}_c1s"].astype(np.int64) *
              cospi[t[f"{name}_s{s}_c1i"]]).astype(wdtype)
        xa = x[..., a]
        xb = x[..., b]
        btf = (w0 * xa + w1 * xb + half) >> cos_bit
        lin = lw0 * xa + lw1 * xb
        if clamp_bits is not None and clamp.any():
            lin = xp.where(clamp, _clamp_bits(lin, clamp_bits, xp), lin)
        x = xp.where(mode, btf, lin)
    return x


def _adst4(x, cos_bit: int, xp=np, forward: bool = False):
    """4-point ADST, sinpi-based (ref transforms.c svt_av1_fadst4_new /
    inv_transforms.c svt_av1_iadst4_new). No clamping by design."""
    sinpi = sinpi_arr(cos_bit)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    if forward:
        s0 = sinpi[1] * x0
        s1 = sinpi[4] * x0
        s2 = sinpi[2] * x1
        s3 = sinpi[1] * x1
        s4 = sinpi[3] * x2
        s5 = sinpi[4] * x3
        s6 = sinpi[2] * x3
        s7 = (x0 + x1) - x3
        t0 = s0 + s2 + s5
        t1 = sinpi[3] * s7
        t2 = s1 - s3 + s6
        t3 = s4
        o0 = t0 + t3
        o1 = t1
        o2 = t2 - t3
        o3 = t2 - t0 + t3
    else:
        s0 = sinpi[1] * x0
        s1 = sinpi[2] * x0
        s2 = sinpi[3] * x1
        s3 = sinpi[4] * x2
        s4 = sinpi[1] * x2
        s5 = sinpi[2] * x3
        s6 = sinpi[4] * x3
        s7 = (x0 - x2) + x3
        t0 = s0 + s3 + s5
        t1 = s1 - s4 - s6
        t3 = s2
        t2 = sinpi[3] * s7
        o0 = t0 + t3
        o1 = t1 + t3
        o2 = t2
        o3 = (t0 + t1) - t3
    half = 1 << (cos_bit - 1)
    return xp.stack([(o + half) >> cos_bit for o in (o0, o1, o2, o3)], axis=-1)


def _identity(x, n: int, xp=np):
    """N-point identity transform scaling (same fwd and inv; ref *_identity*_c)."""
    if n == 4:
        return round_shift(x * NEW_SQRT2, NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return round_shift(x * 2 * NEW_SQRT2, NEW_SQRT2_BITS)
    if n == 32:
        return x * 4
    if n == 64:
        return round_shift(x * 4 * NEW_SQRT2, NEW_SQRT2_BITS)
    raise ValueError(n)


def _run_1d(x, kind: int, n: int, cos_bit: int, clamp_bits, xp=np,
            forward: bool = False, wdtype=np.int64):
    """kind: 0=DCT 1=ADST 2=FLIPADST 3=IDTX. Flip handling happens in 2D."""
    if kind == 3:
        return _identity(x, n, xp)
    if kind in (1, 2):
        if n == 4:
            return _adst4(x, cos_bit, xp, forward)
        name = f"{'f' if forward else 'i'}adst{n}"
    else:
        name = f"{'f' if forward else 'i'}dct{n}"
    return _run_stages(x, name, cos_bit, None if forward else clamp_bits, xp,
                       wdtype)


def _rect_type(w: int, h: int) -> int:
    return abs(int(math.log2(w)) - int(math.log2(h)))


# ---------------------------------------------------------------------------
# 2-D inverse (normative): coeff (..., ch, cw) -> residual (..., h, w)
# ---------------------------------------------------------------------------

def inverse_transform_2d(coeff, tx_size: int, tx_type: int, bd: int = 8, xp=np):
    """Normative inverse transform (without the add-to-prediction step).

    coeff: (..., ch, cw) with ch=min(h,32), cw=min(w,32) (the kept coefficients
    for 64-wide/high transforms). Returns int32 residual (..., h, w).
    Mirrors ref inv_txfm2d_add_c (inv_transforms.c:2459-2537) exactly.
    """
    w, h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
    cw, ch = min(w, 32), min(h, 32)
    wdtype = xp.int64 if xp is np else xp.int32
    coeff = xp.asarray(coeff).astype(wdtype)
    batch = coeff.shape[:-2]
    assert coeff.shape[-2:] == (ch, cw), (coeff.shape, ch, cw)
    if (cw, ch) != (w, h):
        pad = [(0, 0)] * len(batch) + [(0, h - ch), (0, w - cw)]
        coeff = xp.pad(coeff, pad)

    vk, hk = VTX_TAB[tx_type], HTX_TAB[tx_type]
    ud_flip, lr_flip = vk == 2, hk == 2
    s0, s1 = INV_SHIFT[tx_size]
    range_row = 16 if bd == 8 else (18 if bd == 10 else 20)
    range_col = 16 if bd <= 10 else 18

    x = coeff  # (..., h, w): rows of length w
    if _rect_type(w, h) == 1:
        x = round_shift(x * NEW_INV_SQRT2, NEW_SQRT2_BITS)
    x = _clamp_bits(x, bd + 8, xp)
    x = _run_1d(x, hk, w, INV_COS_BIT, range_row, xp,
                wdtype=wdtype)                              # row transform
    x = _round_shift_array(x, -s0)

    x = xp.swapaxes(x, -1, -2)  # (..., w, h): columns
    if lr_flip:
        x = xp.flip(x, axis=-2)
    x = _clamp_bits(x, max(bd + 6, 16), xp)
    x = _run_1d(x, vk, h, INV_COS_BIT, range_col, xp,
                wdtype=wdtype)                              # column transform
    x = _round_shift_array(x, -s1)
    if ud_flip:
        x = xp.flip(x, axis=-1)
    return xp.swapaxes(x, -1, -2).astype(xp.int32)          # (..., h, w)


def inverse_transform_add(coeff, pred, tx_size: int, tx_type: int, bd: int = 8,
                          xp=np):
    """recon = clip(pred + inv_txfm(coeff), 0, 2^bd - 1); pred (..., h, w) uint."""
    resid = inverse_transform_2d(coeff, tx_size, tx_type, bd, xp)
    rec = xp.asarray(pred).astype(xp.int32) + resid
    return xp.clip(rec, 0, (1 << bd) - 1).astype(xp.uint16)


# ---------------------------------------------------------------------------
# 2-D forward: residual (..., h, w) -> coeff (..., ch, cw)
# ---------------------------------------------------------------------------

def forward_transform_2d(resid, tx_size: int, tx_type: int, bd: int = 8, xp=np):
    """Integer forward transform matching the reference encoder
    (ref av1_tranform_two_d_core_c, transforms.c:2259-2326). resid: int
    residual (source - prediction). Returns int32 coeffs (..., ch, cw)."""
    w, h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
    cw, ch = min(w, 32), min(h, 32)
    txw_idx = int(math.log2(w)) - 2
    txh_idx = int(math.log2(h)) - 2
    s = FWD_SHIFT[tx_size]
    cos_bit_col = FWD_COS_BIT_COL[txw_idx][txh_idx]
    cos_bit_row = FWD_COS_BIT_ROW[txw_idx][txh_idx]
    vk, hk = VTX_TAB[tx_type], HTX_TAB[tx_type]
    ud_flip, lr_flip = vk == 2, hk == 2

    wdtype = xp.int64 if xp is np else xp.int32
    x = xp.asarray(resid).astype(wdtype)
    assert x.shape[-2:] == (h, w)

    # Columns first
    if ud_flip:
        x = xp.flip(x, axis=-2)
    x = xp.swapaxes(x, -1, -2)             # (..., w, h)
    x = _round_shift_array(x, -s[0])
    x = _run_1d(x, vk, h, cos_bit_col, None, xp, forward=True, wdtype=wdtype)
    x = _round_shift_array(x, -s[1])
    if lr_flip:
        x = xp.flip(x, axis=-2)
    x = xp.swapaxes(x, -1, -2)             # (..., h, w)

    # Rows
    x = _run_1d(x, hk, w, cos_bit_row, None, xp, forward=True, wdtype=wdtype)
    x = _round_shift_array(x, -s[2])
    if _rect_type(w, h) == 1:
        x = round_shift(x * NEW_SQRT2, NEW_SQRT2_BITS)

    return x[..., :ch, :cw].astype(xp.int32)
