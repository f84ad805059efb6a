"""ctypes bridge to the native entropy backend (native/ec_backend.c).

Builds the shared library on demand with the system compiler (pybind11 is
not available in this image; ctypes keeps the dependency surface at zero).
The native encoder is a drop-in for entropy.range_coder.RangeEncoder and
entropy.coeff_coder.encode_txb — equivalence is pinned by tests.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_NATIVE = pathlib.Path(__file__).parent.parent / "native"
_SRCS = [_NATIVE / "ec_backend.c", _NATIVE / "txfm_backend.c",
         _NATIVE / "commit_backend.c", _NATIVE / "dlf_backend.c",
         _NATIVE / "inter_backend.c", _NATIVE / "cdef_backend.c",
         _NATIVE / "lr_syntax.c"]
_HDRS = [_NATIVE / "tpu_native.h", _NATIVE / "commit_internal.h"]
_SO = _NATIVE / "libtpuec.so"

_lib = None
_txfm_ready = False
_kept_alive = []
# guards the one-time build/load and table setup: encoders on several
# threads (the CLI's --nch channels) may all reach them at once
_init_lock = threading.RLock()


class TxbCdfs(ctypes.Structure):
    _fields_ = [(n, ctypes.POINTER(ctypes.c_uint16)) for n in (
        "eob_flag16", "eob_flag32", "eob_flag64", "eob_flag128",
        "eob_flag256", "eob_flag512", "eob_flag1024", "eob_extra",
        "coeff_base_eob", "coeff_base", "coeff_br", "dc_sign")]


def _src_digest() -> str:
    import hashlib
    h = hashlib.sha256()
    for x in _SRCS + _HDRS:
        h.update(x.read_bytes())
    return h.hexdigest()


def _build():
    cmd = ["cc", "-O3", "-march=native", "-funroll-loops", "-shared",
           "-fPIC", "-o", str(_SO)] + [str(x) for x in _SRCS]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # portable fallback (e.g. cross or restricted toolchains)
        cmd = ["cc", "-O3", "-shared", "-fPIC", "-o", str(_SO)] + \
            [str(x) for x in _SRCS]
        subprocess.run(cmd, check=True)
    (_NATIVE / ".build_hash").write_text(_src_digest())


def get_lib():
    if _lib is not None:
        return _lib
    with _init_lock:
        return _lib if _lib is not None else _load_lib()


def _load_lib():
    global _lib
    # content-hash rebuild check: mtimes are unreliable after checkout
    stamp = _NATIVE / ".build_hash"
    if not _SO.exists() or not stamp.exists() or \
            stamp.read_text().strip() != _src_digest():
        _build()
    lib = ctypes.CDLL(str(_SO))
    lib.tpuec_new.restype = ctypes.c_void_p
    lib.tpuec_free.argtypes = [ctypes.c_void_p]
    lib.tpuec_symbol.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint16),
                                 ctypes.c_int, ctypes.c_int]
    lib.tpuec_bool.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint]
    lib.tpuec_literal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.tpuec_tell_bits.argtypes = [ctypes.c_void_p]
    lib.tpuec_tell_bits.restype = ctypes.c_int
    lib.tpuec_done.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.tpuec_done.restype = ctypes.c_int
    lib.tpuec_encode_txb.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(TxbCdfs),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpuec_encode_txb.restype = ctypes.c_int
    lib.tpuec_cost_txb.argtypes = [
        ctypes.POINTER(TxbCdfs),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpuec_cost_txb.restype = ctypes.c_int
    lib.tpuec_cost_symbol.argtypes = [ctypes.POINTER(ctypes.c_uint16),
                                      ctypes.c_int, ctypes.c_int]
    lib.tpuec_cost_symbol.restype = ctypes.c_int
    lib.tputx_rd_txb.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(TxbCdfs),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int)]
    lib.tputx_rd_txb.restype = ctypes.c_double
    _lib = lib
    return lib


def _u16p(arr: np.ndarray):
    assert arr.dtype == np.uint16 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def make_txb_cdfs(fc) -> TxbCdfs:
    """Bind a FrameContext's coefficient tables (adapted IN PLACE by C)."""
    return TxbCdfs(
        _u16p(fc.eob_flag16), _u16p(fc.eob_flag32), _u16p(fc.eob_flag64),
        _u16p(fc.eob_flag128), _u16p(fc.eob_flag256), _u16p(fc.eob_flag512),
        _u16p(fc.eob_flag1024), _u16p(fc.eob_extra), _u16p(fc.coeff_base_eob),
        _u16p(fc.coeff_base), _u16p(fc.coeff_br), _u16p(fc.dc_sign))


class NativeRangeEncoder:
    """Drop-in for entropy.range_coder.RangeEncoder backed by C."""

    def __init__(self):
        self._lib = get_lib()
        self._ec = self._lib.tpuec_new()

    def __del__(self):
        try:
            self._lib.tpuec_free(self._ec)
        except Exception:
            pass

    def encode_symbol(self, s, icdf, nsyms=None, adapt=False):
        if nsyms is None:
            nsyms = len(icdf) - 1
        self._lib.tpuec_symbol(self._ec, int(s), _u16p(icdf), int(nsyms),
                               1 if adapt else 0)

    def encode_bool(self, val, f):
        self._lib.tpuec_bool(self._ec, int(val), int(f))

    def encode_literal(self, value, bits):
        self._lib.tpuec_literal(self._ec, int(value), int(bits))

    def encode_golomb(self, value):
        length = (value + 1).bit_length()
        for _ in range(length - 1):
            self.encode_literal(0, 1)
        self.encode_literal(value + 1, length)

    def tell_bits(self):
        return self._lib.tpuec_tell_bits(self._ec)

    def encode_txb(self, cdfs: TxbCdfs, qcoeff: np.ndarray, scan: np.ndarray,
                   w, h, rw, rh, ems, txs_ctx, tx_class, ptype,
                   sign_ctx) -> int:
        q = np.ascontiguousarray(qcoeff, np.int32)
        s = np.ascontiguousarray(scan, np.int16)
        return self._lib.tpuec_encode_txb(
            self._ec, ctypes.byref(cdfs),
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(s), w, h, rw, rh, ems, txs_ctx, tx_class, ptype, sign_ctx)

    def done(self) -> bytes:
        cap = self.tell_bits() // 8 + 64
        out = (ctypes.c_uint8 * cap)()
        n = self._lib.tpuec_done(self._ec, out, cap)
        assert n >= 0
        return bytes(out[:n])


def rd_txb(resid: np.ndarray, tx_size: int, tx_type: int, pq, scan,
           cw, ch, rw, rh, ems, txs_ctx, tx_class, ptype, sign_ctx,
           cdfs, bd: int = 8):
    """Fused fwd+quant+inv+SSE+rate trial (one C call). Returns
    (sse, qcoeff, rate512)."""
    from svt_av1_psy_tpu.ops.quant import tx_scale
    lib = ensure_txfms()
    r = np.ascontiguousarray(resid, np.int32)
    qc = np.empty((ch, cw), np.int32)
    rate = ctypes.c_int(0)
    sc = np.ascontiguousarray(scan, np.int16)
    sse = lib.tputx_rd_txb(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tx_size, tx_type, bd, tx_scale(tx_size),
        int(pq.zbin[0]), int(pq.zbin[1]), int(pq.round[0]),
        int(pq.round[1]), int(pq.quant[0]), int(pq.quant[1]),
        int(pq.quant_shift[0]), int(pq.quant_shift[1]),
        int(pq.dequant[0]), int(pq.dequant[1]),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(sc),
        cw, ch, rw, rh, ems, txs_ctx, tx_class, ptype, sign_ctx,
        ctypes.byref(cdfs),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(rate))
    return sse, qc, rate.value


def cost_symbol(icdf: np.ndarray, s: int, nsyms=None) -> int:
    """Exact bit cost (1/512-bit units) of symbol s under a live icdf."""
    if nsyms is None:
        nsyms = len(icdf) - 1
    return get_lib().tpuec_cost_symbol(_u16p(np.ascontiguousarray(icdf)),
                                       int(nsyms), int(s))


def cost_txb(cdfs: TxbCdfs, qcoeff: np.ndarray, scan: np.ndarray,
             w, h, rw, rh, ems, txs_ctx, tx_class, ptype, sign_ctx) -> int:
    """Exact rate (1/512-bit units) of a txb's post-skip symbols, computed
    from the live CDFs without writing or adapting (ref av1_cost_coeffs)."""
    q = np.ascontiguousarray(qcoeff, np.int32)
    s = np.ascontiguousarray(scan, np.int16)
    return get_lib().tpuec_cost_txb(
        ctypes.byref(cdfs),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(s), w, h, rw, rh, ems, txs_ctx, tx_class, ptype, sign_ctx)


# --- frame commit engine (commit_backend.c) --------------------------------

class ModeCdfs(ctypes.Structure):
    _fields_ = [(n, ctypes.POINTER(ctypes.c_uint16)) for n in (
        "partition", "skip", "kf_y", "angle_delta", "uv_mode",
        "intra_ext_tx", "delta_q", "tx_size", "txb_skip",
        "wiener_restore", "sgrproj_restore", "switchable_restore",
        "cfl_sign", "cfl_alpha", "filter_intra", "filter_intra_mode")]


def make_mode_cdfs(fc) -> ModeCdfs:
    """Bind a FrameContext's mode tables (adapted IN PLACE by C)."""
    return ModeCdfs(
        _u16p(fc.partition), _u16p(fc.skip), _u16p(fc.kf_y),
        _u16p(fc.angle_delta), _u16p(fc.uv_mode), _u16p(fc.intra_ext_tx),
        _u16p(fc.delta_q), _u16p(fc.tx_size), _u16p(fc.txb_skip),
        _u16p(fc.wiener_restore), _u16p(fc.sgrproj_restore),
        _u16p(fc.switchable_restore), _u16p(fc.cfl_sign),
        _u16p(fc.cfl_alpha), _u16p(fc.filter_intra),
        _u16p(fc.filter_intra_mode))


class InterCdfs(ctypes.Structure):
    _fields_ = [("y_mode", ctypes.POINTER(ctypes.c_uint16)),
                ("intra_inter", ctypes.POINTER(ctypes.c_uint16)),
                ("single_ref", ctypes.POINTER(ctypes.c_uint16)),
                ("newmv", ctypes.POINTER(ctypes.c_uint16)),
                ("zeromv", ctypes.POINTER(ctypes.c_uint16)),
                ("refmv", ctypes.POINTER(ctypes.c_uint16)),
                ("drl", ctypes.POINTER(ctypes.c_uint16)),
                ("nmv_joints", ctypes.POINTER(ctypes.c_uint16)),
                ("inter_ext_tx", ctypes.POINTER(ctypes.c_uint16)),
                ("comp_inter", ctypes.POINTER(ctypes.c_uint16)),
                ("comp_ref_type", ctypes.POINTER(ctypes.c_uint16)),
                ("comp_ref", ctypes.POINTER(ctypes.c_uint16)),
                ("comp_bwdref", ctypes.POINTER(ctypes.c_uint16)),
                ("inter_compound_mode", ctypes.POINTER(ctypes.c_uint16)),
                ("skip_mode", ctypes.POINTER(ctypes.c_uint16)),
                ("switchable_interp", ctypes.POINTER(ctypes.c_uint16)),
                ("comp_group_idx", ctypes.POINTER(ctypes.c_uint16)),
                ("compound_type", ctypes.POINTER(ctypes.c_uint16)),
                ("wedge_idx", ctypes.POINTER(ctypes.c_uint16)),
                ("obmc", ctypes.POINTER(ctypes.c_uint16)),
                ("motion_mode", ctypes.POINTER(ctypes.c_uint16)),
                ("interintra", ctypes.POINTER(ctypes.c_uint16)),
                ("interintra_mode", ctypes.POINTER(ctypes.c_uint16)),
                ("wedge_interintra", ctypes.POINTER(ctypes.c_uint16))] + [
                (n, ctypes.POINTER(ctypes.c_uint16) * 2) for n in (
                    "sign", "classes", "class0", "bits", "class0_fp",
                    "fp", "class0_hp", "hp")] + [
                ("txfm_partition", ctypes.POINTER(ctypes.c_uint16))]


def make_inter_cdfs(fc) -> InterCdfs:
    """Bind a FrameContext's inter tables (adapted IN PLACE by C)."""
    ic = InterCdfs(
        _u16p(fc.y_mode), _u16p(fc.intra_inter), _u16p(fc.single_ref),
        _u16p(fc.newmv), _u16p(fc.zeromv), _u16p(fc.refmv), _u16p(fc.drl),
        _u16p(fc.nmv_joints), _u16p(fc.inter_ext_tx),
        _u16p(fc.comp_inter), _u16p(fc.comp_ref_type), _u16p(fc.comp_ref),
        _u16p(fc.comp_bwdref), _u16p(fc.inter_compound_mode),
        _u16p(fc.skip_mode), _u16p(fc.switchable_interp),
        _u16p(fc.comp_group_idx), _u16p(fc.compound_type),
        _u16p(fc.wedge_idx), _u16p(fc.obmc), _u16p(fc.motion_mode),
        _u16p(fc.interintra), _u16p(fc.interintra_mode),
        _u16p(fc.wedge_interintra))
    for name in ("sign", "classes", "class0", "bits", "class0_fp", "fp",
                 "class0_hp", "hp"):
        pair = (ctypes.POINTER(ctypes.c_uint16) * 2)(
            _u16p(fc.nmv_comp[f"comp0_{name}_cdf"]),
            _u16p(fc.nmv_comp[f"comp1_{name}_cdf"]))
        setattr(ic, name, pair)
    ic.txfm_partition = _u16p(fc.txfm_partition)
    return ic


_commit_ready = False


def _ensure_commit(lib):
    global _commit_ready
    if _commit_ready:
        return
    with _init_lock:
        if _commit_ready:
            return
        _ensure_commit_locked(lib)


def _ensure_commit_locked(lib):
    global _commit_ready
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpuc_new.restype = ctypes.c_void_p
    lib.tpuc_new.argtypes = [ctypes.c_int] * 3
    lib.tpuc_free.argtypes = [ctypes.c_void_p]
    lib.tpuc_set_src.argtypes = [ctypes.c_void_p, u16p, u16p, u16p,
                                 ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_qtab.argtypes = [ctypes.c_void_p, i32p]
    lib.tpuc_attach_planes.argtypes = [ctypes.c_void_p, u16p, u16p, u16p,
                                       ctypes.c_int, ctypes.c_int]
    lib.tpuc_attach_lfmaps.argtypes = [ctypes.c_void_p, u8p, u8p,
                                       ctypes.c_int, ctypes.c_int]
    lib.tpuc_attach_skipmap.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
    lib.tpuc_set_psy_rd.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tpuc_set_rdmult_scale.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.tpuc_set_qm.argtypes = [ctypes.c_void_p] + [i32p] * 6
    lib.tpuc_set_noise_norm.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_tune_ssim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_max_tx32.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_lr.argtypes = [ctypes.c_void_p, i32p, i32p,
                                i16p, i16p, i16p, i32p, i32p]
    lib.tpui_mc_block.argtypes = [u16p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.tpue_cdef.argtypes = [
        u16p, ctypes.c_int, u16p, u16p, ctypes.c_int,
        u16p, u16p, u16p,
        u16p, ctypes.c_int, u16p, u16p, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double)]
    i32cp = ctypes.POINTER(ctypes.c_int)
    lib.tpue_cdef_unit_sse.argtypes = [
        u16p, ctypes.c_int, u16p, u16p, ctypes.c_int,
        u16p, ctypes.c_int, u16p, u16p, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32cp, ctypes.c_int, i32cp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        u8p]
    lib.tpue_cdef_apply_idx.argtypes = [
        u16p, ctypes.c_int, u16p, u16p, ctypes.c_int,
        u16p, u16p, u16p,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32cp, i32cp, u8p, ctypes.c_int, ctypes.c_int]
    lib.tpud_apply_plane.argtypes = [u16p, ctypes.c_int, u8p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.tpud_try_level.restype = ctypes.c_double
    lib.tpud_try_level.argtypes = [u16p, ctypes.c_int, u16p, ctypes.c_int,
                                   u16p, u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    lib.tpuc_plane.restype = u16p
    lib.tpuc_plane.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)]
    lib.tpuc_upload_scan.argtypes = [ctypes.c_int, ctypes.c_int, i16p,
                                     ctypes.c_int]
    lib.tpuc_upload_dr.argtypes = [i32p]
    lib.tpuc_encode_intra.restype = ctypes.c_int64
    lib.tpuc_encode_intra.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ModeCdfs),
        ctypes.POINTER(TxbCdfs)] + [u8p] * 7 + [
        i16p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_ref.argtypes = [ctypes.c_void_p, u16p, u16p, u16p,
                                 ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_gm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_gm_warp.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.tpuc_set_gm_warp.restype = ctypes.c_int
    lib.tpuc_set_interp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.tpuc_set_ref3.argtypes = [ctypes.c_void_p, u16p, u16p, u16p,
                                  ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_ref_sel.argtypes = [ctypes.c_void_p, u8p, i16p,
                                     ctypes.c_int]
    lib.tpuc_set_ref2.argtypes = [ctypes.c_void_p, u16p, u16p, u16p,
                                  ctypes.c_int, ctypes.c_int]
    lib.tpuc_set_compound.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p,
                                      ctypes.c_int]
    lib.tpuc_upload_wedge.argtypes = [ctypes.c_int, i32p, ctypes.c_int]
    lib.tpuc_upload_ii.argtypes = [ctypes.c_int, ctypes.c_int, i32p,
                                   ctypes.c_int]
    lib.tpuc_set_obmc.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.tpuc_set_interintra.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_cfl.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_filter_intra.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_upload_fi.argtypes = [i32p]
    lib.tpuc_set_tx_select.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_set_allow_hp.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuc_upload_warp.argtypes = [i32p, i32p]
    lib.tpuc_set_tpl.argtypes = [ctypes.c_void_p, i16p, i16p, u8p,
                                 ctypes.c_int, ctypes.c_int, i32p,
                                 ctypes.c_int]
    lib.tpuc_grid_read.restype = ctypes.c_int
    lib.tpuc_grid_read.argtypes = [ctypes.c_void_p, i8p, i8p, i16p, i16p]
    lib.tpuc_encode_inter.restype = ctypes.c_int64
    lib.tpuc_encode_inter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ModeCdfs),
        ctypes.POINTER(TxbCdfs), ctypes.POINTER(InterCdfs)] + [u8p] * 7 + [
        i16p, i16p, ctypes.c_int, i16p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]

    # upload scan tables + directional derivative table once
    from svt_av1_psy_tpu.constants import get_scan, tables
    from svt_av1_psy_tpu.entropy.tx_sets import EXT_TX_INV
    dr = np.ascontiguousarray(tables()["dr_intra_derivative"], np.int32)
    lib.tpuc_upload_dr(dr.ctypes.data_as(i32p))
    wf = np.ascontiguousarray(tables()["warped_filter"], np.int32)
    dl = np.ascontiguousarray(tables()["warp_div_lut"], np.int32)
    lib.tpuc_upload_warp(wf.ctypes.data_as(i32p), dl.ctypes.data_as(i32p))
    # wedge mask tables (spec 7.11.3.11) for the masked-compound search
    from svt_av1_psy_tpu.inter.masks import get_wedge_mask
    for which, bs in enumerate((3, 6, 9)):       # 8x8 / 16x16 / 32x32
        n = 8 << which
        tab = np.zeros((16, 2, n, n), np.int32)
        for wi in range(16):
            for sg in range(2):
                tab[wi, sg] = get_wedge_mask(bs, wi, sg)
        tab = np.ascontiguousarray(tab)
        lib.tpuc_upload_wedge(which, tab.ctypes.data_as(i32p), n)
    # filter-intra taps (spec 7.11.6) for the fast-path fi candidates
    fit = np.ascontiguousarray(tables()["filter_intra_taps"], np.int32)
    lib.tpuc_upload_fi(fit.ctypes.data_as(i32p))
    # smooth inter-intra masks (spec 7.11.3.13) for the II search:
    # sizes 4..32 cover luma 8..32 + their chroma halves
    from svt_av1_psy_tpu.inter.masks import smooth_interintra_mask
    for mode in range(4):
        for sidx, n in enumerate((4, 8, 16, 32)):
            m = np.ascontiguousarray(
                smooth_interintra_mask(mode, n, n), np.int32)
            lib.tpuc_upload_ii(mode, sidx, m.ctypes.data_as(i32p), n)
    for ts in range(19):
        for tt in range(16):
            try:
                scan = np.ascontiguousarray(get_scan(ts, tt), np.int16)
            except KeyError:
                continue
            lib.tpuc_upload_scan(ts, tt, scan.ctypes.data_as(i16p),
                                 len(scan))
    # prime the prob-cost table single-threaded (tile walks run in threads)
    dummy = np.array([16384, 0], np.uint16)
    lib.tpuec_cost_symbol(_u16p(dummy), 2, 0)
    _commit_ready = True


_qtab_cache = {}


def build_qtab(bd: int = 8, sharpness: int = 0,
               base_q: int = -1) -> np.ndarray:
    """Quantizer table for all 256 qindexes x 3 planes x 10 params
    (zbin dc/ac, round dc/ac, quant dc/ac, quant_shift dc/ac, dequant
    dc/ac), consumed by the C commit engine. Cached per
    (bd, sharpness, base_q); sharpness applies the PSY diff-based quant
    bias (ref md_config_process.c:96-117)."""
    key = (bd, sharpness, base_q if sharpness else -1)
    if key in _qtab_cache:
        return _qtab_cache[key]
    from svt_av1_psy_tpu.ops.quant import build_plane_quant
    out = np.zeros((256, 3, 10), np.int32)
    for q in range(256):
        pq = build_plane_quant(q, bd=bd, sharpness=sharpness,
                               base_q=base_q)
        row = [int(pq.zbin[0]), int(pq.zbin[1]), int(pq.round[0]),
               int(pq.round[1]), int(pq.quant[0]), int(pq.quant[1]),
               int(pq.quant_shift[0]), int(pq.quant_shift[1]),
               int(pq.dequant[0]), int(pq.dequant[1])]
        for p in range(3):
            out[q, p] = row
    out = np.ascontiguousarray(out)
    _qtab_cache[key] = out
    return out


class CommitEngine:
    """ctypes wrapper over the native frame commit walk."""

    def __init__(self, width: int, height: int, bd: int = 8,
                 sharpness: int = 0, base_q: int = -1):
        self.lib = ensure_txfms()
        _ensure_commit(self.lib)
        self._c = self.lib.tpuc_new(width, height, bd)
        self.width, self.height, self.bd = width, height, bd
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        qt = build_qtab(bd, sharpness, base_q)
        self._qt = np.ascontiguousarray(qt)
        self.lib.tpuc_set_qtab(
            self._c, self._qt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        self._keep = []

    def __del__(self):
        try:
            self.lib.tpuc_free(self._c)
        except Exception:
            pass

    def set_src(self, yp: np.ndarray, up: np.ndarray, vp: np.ndarray):
        """Padded source planes (uint16, C-contiguous)."""
        u16p = ctypes.POINTER(ctypes.c_uint16)
        self._keep = [np.ascontiguousarray(p, np.uint16)
                      for p in (yp, up, vp)]
        y, u, v = self._keep
        self.lib.tpuc_set_src(self._c, y.ctypes.data_as(u16p),
                              u.ctypes.data_as(u16p), v.ctypes.data_as(u16p),
                              y.shape[1], u.shape[1])

    def set_ref(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Reference recon planes (uint16) for the P-frame walk."""
        u16p = ctypes.POINTER(ctypes.c_uint16)
        self._ref = (y, u, v)
        self.lib.tpuc_set_ref(self._c, y.ctypes.data_as(u16p),
                              u.ctypes.data_as(u16p),
                              v.ctypes.data_as(u16p), y.shape[1],
                              u.shape[1])

    def set_gm_warp(self, mat6) -> bool:
        """LAST-ref ROTZOOM global motion (full 6-param mat); returns
        False when the shear params do not validate (the model must
        then not be signalled)."""
        arr = (ctypes.c_int32 * 6)(*[int(v) for v in mat6])
        return bool(self.lib.tpuc_set_gm_warp(self._c, arr))

    def set_gm(self, mv8):
        """LAST-ref TRANSLATION global MV (1/8 px, precision-lowered);
        (0, 0) disarms (identity gm)."""
        self.lib.tpuc_set_gm(self._c, int(mv8[0]), int(mv8[1]))

    def set_interp(self, switchable: bool, gm_coded: bool):
        """Enable per-block interpolation-filter signalling + search
        (frame header is_filter_switchable); gm_coded gates the
        is_nontrans_global_motion no-filter rule for GLOBALMV blocks."""
        self.lib.tpuc_set_interp(self._c, int(switchable), int(gm_coded))

    def set_ref2(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Second (future / ALTREF) reference recon for compound."""
        u16p = ctypes.POINTER(ctypes.c_uint16)
        self._ref2 = (y, u, v)
        self.lib.tpuc_set_ref2(self._c, y.ctypes.data_as(u16p),
                               u.ctypes.data_as(u16p),
                               v.ctypes.data_as(u16p), y.shape[1],
                               u.shape[1])

    def set_ref3(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Third (GOLDEN) reference recon for multi-reference
        prediction (ref pd_process.c ref lists)."""
        u16p = ctypes.POINTER(ctypes.c_uint16)
        self._ref3 = (y, u, v)
        self.lib.tpuc_set_ref3(self._c, y.ctypes.data_as(u16p),
                               u.ctypes.data_as(u16p),
                               v.ctypes.data_as(u16p), y.shape[1],
                               u.shape[1])

    def set_ref_sel(self, sel: np.ndarray, mv16g: np.ndarray):
        """Per-16x16 single-ref choice map (0 = LAST, 1 = GOLDEN,
        2 = ALTREF) + GOLDEN HME seed field (the ME-SAD ref pruning of
        motion_estimation.c:1615; ALTREF seeds ride the compound mv16b
        field already passed to encode_inter)."""
        sel = np.ascontiguousarray(sel, np.uint8)
        mv16g = np.ascontiguousarray(mv16g, np.int16)
        self._refsel = (sel, mv16g)
        self.lib.tpuc_set_ref_sel(
            self._c, sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mv16g.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            sel.shape[1])

    def set_compound(self, skip_mode_present: bool, sign_bias,
                     masked: bool = False):
        """Frame-level compound state: skip-mode allowance +
        RefFrameSignBias[0..7] (index 1 = LAST) + masked-compound
        (wedge/diffwtd) search & syntax."""
        sb = np.ascontiguousarray(sign_bias, np.uint8)
        assert sb.size == 8
        self._sb = sb
        self.lib.tpuc_set_compound(
            self._c, int(skip_mode_present),
            sb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(masked))

    def set_allow_hp(self, enable: bool):
        """allow_high_precision_mv: eighth-pel MV search + hp bits in
        the MV writer; MVP candidates keep eighth precision (spec
        lower_mv_precision is skipped). Call AFTER set_tpl (which also
        initializes the flag for the MVP builder)."""
        self.lib.tpuc_set_allow_hp(self._c, int(enable))

    def set_tx_select(self, enable: bool):
        """TX_MODE_SELECT intra walk: per-block depth-1 TX split search
        + tx_size depth signalling (frame tx_mode_select must be 1)."""
        self.lib.tpuc_set_tx_select(self._c, int(enable))

    def set_obmc(self, enable: bool, allow_warp: bool = False):
        """Motion-mode search (frame is_motion_mode_switchable): trial
        OBMC_CAUSAL (and WARPED_CAUSAL when allow_warp, frame
        allow_warped_motion) on eligible single-ref blocks + write the
        motion-mode symbol."""
        self.lib.tpuc_set_obmc(self._c, int(enable), int(allow_warp))

    def set_cfl(self, enable: bool):
        """CfL chroma candidate in the intra walk (spec 7.11.5):
        LS-alpha search on the reconstructed-luma AC."""
        self.lib.tpuc_set_cfl(self._c, int(enable))

    def set_filter_intra(self, enable: bool):
        """Filter-intra candidates in the intra walk (spec 7.11.6)."""
        self.lib.tpuc_set_filter_intra(self._c, int(enable))

    def set_interintra(self, enable: bool):
        """Inter-intra search (seq enable_interintra_compound): trial
        the smooth II blend on single-ref 8x8..32x32 blocks + write the
        interintra syntax (spec 5.11.28)."""
        self.lib.tpuc_set_interintra(self._c, int(enable))

    def set_tpl(self, tpl_mv, tpl_off, tpl_valid, cur_off8, allow_hp=False):
        """MFMV: attach the frame's projected temporal motion field
        (inter/mfmv.py setup_motion_field output) + per-ref-id
        cur-to-ref distances; the ref-MV stack then inserts temporal
        candidates (spec 7.10.2 add_tpl_ref_mv analog)."""
        i8p = ctypes.POINTER(ctypes.c_int8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        mv = np.ascontiguousarray(tpl_mv, np.int16)
        off = np.ascontiguousarray(tpl_off, np.int16)
        valid = np.ascontiguousarray(tpl_valid, np.uint8)
        co = np.ascontiguousarray(cur_off8, np.int32)
        assert co.size == 8 and mv.shape[:2] == valid.shape
        self._tpl_keep = (mv, off, valid, co)
        self.lib.tpuc_set_tpl(self._c, mv.ctypes.data_as(i16p),
                              off.ctypes.data_as(i16p),
                              valid.ctypes.data_as(u8p),
                              valid.shape[0], valid.shape[1],
                              co.ctypes.data_as(i32p), int(allow_hp))

    def grid_read(self):
        """Export the last encoded frame's per-mi motion info for
        spec 7.20 motion-field storage: (ref0, ref1, mv0, mv1) numpy
        arrays over (mi_rows, mi_cols), or None when no grid is live."""
        i8p = ctypes.POINTER(ctypes.c_int8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        sh = (self.mi_rows, self.mi_cols)
        ref0 = np.empty(sh, np.int8)
        ref1 = np.empty(sh, np.int8)
        mv0 = np.empty(sh + (2,), np.int16)
        mv1 = np.empty(sh + (2,), np.int16)
        ok = self.lib.tpuc_grid_read(self._c, ref0.ctypes.data_as(i8p),
                                     ref1.ctypes.data_as(i8p),
                                     mv0.ctypes.data_as(i16p),
                                     mv1.ctypes.data_as(i16p))
        if not ok:
            return None
        return ref0, ref1, mv0, mv1

    def encode_inter(self, ec, fc, split_maps, mode_maps, mv16, sbq=None,
                     dq_res_log2=-1, base_q=60, mi_bounds=(0, 0, 0, 0),
                     n_cands=1, mv16b=None):
        """P/B-frame walk: split + intra-candidate maps as encode_intra,
        plus per-16x16 full-pel MV seed maps from device HME (mv16
        against LAST; mv16b against the second ref when compound)."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        mc = make_mode_cdfs(fc)
        tc = make_txb_cdfs(fc)
        ic = make_inter_cdfs(fc)
        arrs = []

        def m(x):
            a = np.ascontiguousarray(x, np.uint8)
            arrs.append(a)
            return a.ctypes.data_as(u8p)

        mv = np.ascontiguousarray(mv16, np.int16)
        arrs.append(mv)
        mvb = None
        if mv16b is not None:
            mvb_a = np.ascontiguousarray(mv16b, np.int16)
            arrs.append(mvb_a)
            mvb = mvb_a.ctypes.data_as(i16p)
        sq = None
        if sbq is not None:
            sq_a = np.ascontiguousarray(sbq, np.int16)
            arrs.append(sq_a)
            sq = sq_a.ctypes.data_as(i16p)
        r0, r1, c0, c1 = mi_bounds
        dist = self.lib.tpuc_encode_inter(
            self._c, ec._ec, ctypes.byref(mc), ctypes.byref(tc),
            ctypes.byref(ic),
            m(split_maps[64]), m(split_maps[32]), m(split_maps[16]),
            m(mode_maps[64]), m(mode_maps[32]), m(mode_maps[16]),
            m(mode_maps[8]), mv.ctypes.data_as(i16p), mvb, mv.shape[1],
            sq, dq_res_log2, base_q, r0, r1, c0, c1, n_cands)
        return dist

    def set_psy_rd(self, strength: float):
        """PSY energy-preservation RD strength (the psy_rd.c analog)."""
        self.lib.tpuc_set_psy_rd(self._c, float(strength))

    def set_rdmult_scale(self, scale: float):
        """Frame-kind lambda scale (ref rc_process.c compute_rd_mult:
        rd_frame_type_factor x def_*_rd_multiplier ratios)."""
        self.lib.tpuc_set_rdmult_scale(self._c, float(scale))

    def set_noise_norm(self, strength: int):
        """PSY noise normalization strength 1..4 (ref full_loop.c:1464;
        AC coefficient revival in the encode pass)."""
        self.lib.tpuc_set_noise_norm(self._c, int(strength))

    def set_max_tx32(self, on: bool):
        """PSY max-32-tx-size: cap transforms at 32x32 by forcing the
        depth-1 split of 64-side TX (ref README.md:67-69)."""
        self.lib.tpuc_set_max_tx32(self._c, 1 if on else 0)

    def set_tune_ssim(self, on: bool):
        """Tune 3: SSIM-weighted candidate distortion (the DIST_SSIM arm
        of md_stage_3; ref full_loop.c:2220, enc_mode_config.c:7883)."""
        self.lib.tpuc_set_tune_ssim(self._c, 1 if on else 0)

    def set_qm(self, qm_y: int, qm_u: int, qm_v: int):
        """Arm quantizer matrices at the frame's per-plane levels (spec
        5.9.12; ref md_config_process.c svt_av1_qm_init). Level 15 =
        flat (NULL) for that plane."""
        from svt_av1_psy_tpu.constants import tables
        i32p = ctypes.POINTER(ctypes.c_int32)
        t = tables()
        args = []
        self._qm_keep = []   # own slot: set_src reassigns _keep
        for plane, lvl in ((0, qm_y), (1, qm_u), (2, qm_v)):
            if lvl >= 15:
                args += [None, None]
                continue
            wt = np.ascontiguousarray(t["qm_wt"][lvl, 1 if plane else 0],
                                      np.int32)
            iwt = np.ascontiguousarray(t["qm_iwt"][lvl, 1 if plane else 0],
                                       np.int32)
            self._qm_keep += [wt, iwt]
            args += [wt.ctypes.data_as(i32p), iwt.ctypes.data_as(i32p)]
        self.lib.tpuc_set_qm(self._c, *args)

    def set_lr(self, lr_type, unit_size, unit_arrays, ucols, urows):
        """Arm loop-restoration syntax emission for the next walk.

        lr_type/unit_size: per-plane (enum 0..3 / px); unit_arrays:
        per-plane int16 (urows*ucols, 10) rows {type, vtaps, htaps, ep,
        xqd} or None."""
        i32p = ctypes.POINTER(ctypes.c_int32)
        i16p = ctypes.POINTER(ctypes.c_int16)
        ft = np.ascontiguousarray(lr_type, np.int32)
        us = np.ascontiguousarray(unit_size, np.int32)
        uc = np.ascontiguousarray(ucols, np.int32)
        ur = np.ascontiguousarray(urows, np.int32)
        ptrs = []
        keep = [ft, us, uc, ur]
        for a in unit_arrays:
            if a is None:
                ptrs.append(None)
            else:
                a = np.ascontiguousarray(a, np.int16)
                keep.append(a)
                ptrs.append(a.ctypes.data_as(i16p))
        self._lr_keep = keep
        self.lib.tpuc_set_lr(self._c, ft.ctypes.data_as(i32p),
                             us.ctypes.data_as(i32p), ptrs[0], ptrs[1],
                             ptrs[2], uc.ctypes.data_as(i32p),
                             ur.ctypes.data_as(i32p))

    def attach_skipmap(self, skip: np.ndarray):
        """Shared per-4x4 skip map (CDEF block lists)."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._skipmap = skip
        self.lib.tpuc_attach_skipmap(self._c, skip.ctypes.data_as(u8p),
                                     skip.shape[1])

    def attach_lfmaps(self, txdim_y: np.ndarray, txdim_uv: np.ndarray):
        """Shared per-4px-unit tx-dim maps the engines fill during the
        walk (consumed by the deblocking filter)."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._lfmaps = (txdim_y, txdim_uv)
        self.lib.tpuc_attach_lfmaps(
            self._c, txdim_y.ctypes.data_as(u8p),
            txdim_uv.ctypes.data_as(u8p), txdim_y.shape[1],
            txdim_uv.shape[1])

    def attach_planes(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Share external numpy recon buffers (uint16) across tile engines.
        Tiles write disjoint column bands, so concurrent walks are safe."""
        u16p = ctypes.POINTER(ctypes.c_uint16)
        assert all(p.dtype == np.uint16 and p.flags["C_CONTIGUOUS"]
                   for p in (y, u, v))
        self._shared = (y, u, v)
        self.lib.tpuc_attach_planes(
            self._c, y.ctypes.data_as(u16p), u.ctypes.data_as(u16p),
            v.ctypes.data_as(u16p), y.shape[1], u.shape[1])

    def plane(self, plane: int) -> np.ndarray:
        """Recon plane view (h, stride) uint16 — crop columns yourself."""
        stride = ctypes.c_int(0)
        p = self.lib.tpuc_plane(self._c, plane, ctypes.byref(stride))
        sub = 1 if plane else 0
        h = (self.mi_rows * 4 >> sub) + 64
        arr = np.ctypeslib.as_array(p, shape=(h, stride.value))
        return arr

    def encode_intra(self, ec, fc, split_maps, mode_maps, sbq=None,
                     dq_res_log2=-1, base_q=60, mi_bounds=(0, 0, 0, 0),
                     n_cands=1):
        """Run the commit walk over [mi_row0, mi_row1) x [mi_col0, mi_col1)
        (0s = whole frame). split_maps/mode_maps: dict size->uint8 map.
        ec: NativeRangeEncoder; fc: this tile's FrameContext."""
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        mc = make_mode_cdfs(fc)
        tc = make_txb_cdfs(fc)
        arrs = []

        def m(x):
            a = np.ascontiguousarray(x, np.uint8)
            arrs.append(a)
            return a.ctypes.data_as(u8p)

        sq = None
        if sbq is not None:
            sq_a = np.ascontiguousarray(sbq, np.int16)
            arrs.append(sq_a)
            sq = sq_a.ctypes.data_as(i16p)
        r0, r1, c0, c1 = mi_bounds
        dist = self.lib.tpuc_encode_intra(
            self._c, ec._ec, ctypes.byref(mc), ctypes.byref(tc),
            m(split_maps[64]), m(split_maps[32]), m(split_maps[16]),
            m(mode_maps[64]), m(mode_maps[32]), m(mode_maps[16]),
            m(mode_maps[8]), sq, dq_res_log2, base_q, r0, r1, c0, c1,
            n_cands)
        return dist


_PROF_NAMES = ("fwd_txfm", "quantize", "coeff_rate", "inv_txfm",
               "predict", "commit_ec", "trial_total", "spare",
               "mc_singleref", "mc_compound", "masked_search",
               "motion_modes")


def prof_reset() -> None:
    """Zero the native phase profiler (active when SVT_NATIVE_PROF=1)."""
    get_lib().tpuc_prof_reset()


def prof_get() -> dict:
    """Phase-name -> milliseconds accumulated since the last reset,
    summed across tile threads (buckets 0-4 nest inside 5/6)."""
    buf = (ctypes.c_longlong * 12)()
    get_lib().tpuc_prof_get(buf)
    return {n: v / 1e6 for n, v in zip(_PROF_NAMES, buf)}


def prof_trial_counts() -> dict:
    """tx_size -> tpu_trial_txb call count since the last reset
    (SVT_NATIVE_PROF=1 only; zeroes otherwise)."""
    buf = (ctypes.c_longlong * 19)()
    get_lib().tpuc_prof_counts(buf)
    return {i: int(v) for i, v in enumerate(buf) if v}


def dlf_apply(plane: np.ndarray, txdim: np.ndarray, is_luma: bool,
              level_v: int, level_h: int, sharpness: int, bd: int,
              rows: int, cols: int, w: int = 0, h: int = 0):
    """Apply the normative DLF in place to a uint16 plane. w/h: the
    plane-space DISPLAY dims bounding which mi units filter (spec
    7.14.1); 0 = the full mi grid (mi-aligned frames)."""
    lib = get_lib()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpud_apply_plane(plane.ctypes.data_as(u16p), plane.shape[1],
                         txdim.ctypes.data_as(u8p), txdim.shape[1],
                         rows, cols, int(is_luma), level_v, level_h,
                         sharpness, bd, w, h)


def dlf_try_level(plane: np.ndarray, src: np.ndarray, scratch: np.ndarray,
                  txdim: np.ndarray, is_luma: bool, level: int,
                  sharpness: int, bd: int, rows: int, cols: int,
                  w: int, h: int) -> float:
    """SSE vs source after filtering a copy at `level` (encoder search)."""
    assert plane.dtype == np.uint16 and src.dtype == np.uint16
    lib = get_lib()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    return lib.tpud_try_level(
        plane.ctypes.data_as(u16p), plane.shape[1],
        src.ctypes.data_as(u16p), src.shape[1],
        scratch.ctypes.data_as(u16p), txdim.ctypes.data_as(u8p),
        txdim.shape[1], rows, cols, int(is_luma), level, sharpness, bd,
        w, h)


def mc_block(ref: np.ndarray, px: int, py: int, w: int, h: int,
             mvx_q4: int, mvy_q4: int, bd: int = 8,
             frame_w: int = None, frame_h: int = None) -> np.ndarray:
    """Subpel MC one block from a uint16 reference plane (REGULAR filter,
    normative 7.11.3)."""
    lib = get_lib()
    assert ref.dtype == np.uint16
    u16p = ctypes.POINTER(ctypes.c_uint16)
    out = np.empty((h, w), np.int32)
    lib.tpui_mc_block(ref.ctypes.data_as(u16p), ref.shape[1],
                      frame_w if frame_w else ref.shape[1],
                      frame_h if frame_h else ref.shape[0],
                      px, py, w, h, mvx_q4, mvy_q4, bd,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def cdef_run(planes, srcs, skip: np.ndarray, w: int, h: int, bd: int,
             damping: int, strengths, apply: bool,
             sample: int = 1, n_threads: int = 4):
    """Run CDEF over the frame; returns (sse_y, sse_uv). planes/srcs:
    (y, u, v) uint16 arrays; strengths: (y_pri, y_sec, uv_pri, uv_sec).
    Banded over 64px rows across threads (blocks are independent: reads
    come from an internal pre-CDEF copy)."""
    lib = get_lib()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    py, pu, pv = planes
    sy, su, sv = srcs
    assert all(p.dtype == np.uint16 for p in (py, pu, pv, sy, su, sv))
    if apply:
        iny, inu, inv = py.copy(), pu.copy(), pv.copy()
    else:
        iny, inu, inv = py, pu, pv
    mi_rows, mi_cols = skip.shape
    n64r = (mi_rows + 15) // 16

    def band(fbr0, fbr1):
        sse = (ctypes.c_double * 2)()
        lib.tpue_cdef(py.ctypes.data_as(u16p), py.shape[1],
                      pu.ctypes.data_as(u16p), pv.ctypes.data_as(u16p),
                      pu.shape[1],
                      iny.ctypes.data_as(u16p), inu.ctypes.data_as(u16p),
                      inv.ctypes.data_as(u16p),
                      sy.ctypes.data_as(u16p), sy.shape[1],
                      su.ctypes.data_as(u16p), sv.ctypes.data_as(u16p),
                      su.shape[1],
                      skip.ctypes.data_as(u8p), mi_rows, mi_cols,
                      skip.shape[1], w, h, bd, damping, strengths[0],
                      strengths[1], strengths[2], strengths[3], int(apply),
                      sample, fbr0, fbr1, sse)
        return float(sse[0]), float(sse[1])

    nb = min(n_threads, n64r)
    if nb <= 1:
        return band(0, n64r)
    bounds = [(i * n64r // nb, (i + 1) * n64r // nb) for i in range(nb)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=nb) as tp:
        parts = list(tp.map(lambda b: band(*b), bounds))
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


def cdef_unit_sse(planes, srcs, skip: np.ndarray, w: int, h: int, bd: int,
                  damping: int, ycands, ccands, sample: int = 1,
                  n_threads: int = 4):
    """Per-64x64-unit CDEF SSE for candidate (pri, sec) lists; luma and
    chroma are separable (one index selects a quadruple at signal time).
    Returns (ssey (n64r, n64c, ky), ssec (n64r, n64c, kc),
    has (n64r, n64c) bool)."""
    lib = get_lib()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    py, pu, pv = planes
    sy, su, sv = srcs
    assert all(p.dtype == np.uint16 for p in (py, pu, pv, sy, su, sv))
    mi_rows, mi_cols = skip.shape
    n64r, n64c = (mi_rows + 15) // 16, (mi_cols + 15) // 16
    ky, kc = len(ycands), len(ccands)
    yc = np.ascontiguousarray(np.array(ycands, np.int32).reshape(-1))
    cc = np.ascontiguousarray(np.array(ccands, np.int32).reshape(-1))
    ssey = np.zeros((n64r, n64c, ky), np.float64)
    ssec = np.zeros((n64r, n64c, kc), np.float64)
    has = np.zeros((n64r, n64c), np.uint8)
    f64p = ctypes.POINTER(ctypes.c_double)

    def band(fbr0, fbr1):
        lib.tpue_cdef_unit_sse(
            py.ctypes.data_as(u16p), py.shape[1],
            pu.ctypes.data_as(u16p), pv.ctypes.data_as(u16p), pu.shape[1],
            sy.ctypes.data_as(u16p), sy.shape[1],
            su.ctypes.data_as(u16p), sv.ctypes.data_as(u16p), su.shape[1],
            skip.ctypes.data_as(u8p), mi_rows, mi_cols, skip.shape[1],
            w, h, bd, damping,
            yc.ctypes.data_as(i32p), ky, cc.ctypes.data_as(i32p), kc,
            sample, fbr0, fbr1,
            ssey.ctypes.data_as(f64p), ssec.ctypes.data_as(f64p),
            has.ctypes.data_as(u8p))

    nb = min(n_threads, n64r)
    if nb <= 1:
        band(0, n64r)
    else:
        bounds = [(i * n64r // nb, (i + 1) * n64r // nb) for i in range(nb)]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nb) as tp:
            list(tp.map(lambda b: band(*b), bounds))
    return ssey, ssec, has.astype(bool)


def cdef_apply_idx(planes, skip: np.ndarray, w: int, h: int, bd: int,
                   damping: int, ylist, clist, idx_map: np.ndarray,
                   n_threads: int = 4):
    """Apply per-64x64 CDEF strengths selected by idx_map (n64r x n64c
    uint8) from the signalled (pri, sec) quadruple lists, in place."""
    lib = get_lib()
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    py, pu, pv = planes
    iny, inu, inv = py.copy(), pu.copy(), pv.copy()
    mi_rows, mi_cols = skip.shape
    n64r = (mi_rows + 15) // 16
    yl = np.ascontiguousarray(np.array(ylist, np.int32).reshape(-1))
    cl = np.ascontiguousarray(np.array(clist, np.int32).reshape(-1))
    idx = np.ascontiguousarray(idx_map, np.uint8)

    def band(fbr0, fbr1):
        lib.tpue_cdef_apply_idx(
            py.ctypes.data_as(u16p), py.shape[1],
            pu.ctypes.data_as(u16p), pv.ctypes.data_as(u16p), pu.shape[1],
            iny.ctypes.data_as(u16p), inu.ctypes.data_as(u16p),
            inv.ctypes.data_as(u16p),
            skip.ctypes.data_as(u8p), mi_rows, mi_cols, skip.shape[1],
            w, h, bd, damping,
            yl.ctypes.data_as(i32p), cl.ctypes.data_as(i32p),
            idx.ctypes.data_as(u8p), fbr0, fbr1)

    nb = min(n_threads, n64r)
    if nb <= 1:
        band(0, n64r)
    else:
        bounds = [(i * n64r // nb, (i + 1) * n64r // nb) for i in range(nb)]
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=nb) as tp:
            list(tp.map(lambda b: band(*b), bounds))


# --- native transforms / quantizer -----------------------------------------

def ensure_txfms():
    """Upload stage tables + cospi/sinpi constants into the C backend
    (thread-safe: tile engines construct inside worker threads)."""
    global _txfm_ready
    lib = get_lib()
    if _txfm_ready:
        return lib
    with _init_lock:
        if _txfm_ready:
            return lib
        return _ensure_txfms_locked(lib)


def _ensure_txfms_locked(lib):
    global _txfm_ready
    from svt_av1_psy_tpu.ops.transforms import (_stage_tables, cospi_arr,
                                                sinpi_arr)

    lib.tputx_register.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16)]
    lib.tputx_set_cospi.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.tputx_inv2d.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tputx_fwd2d.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tputx_quantize_b.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32)] + \
        [ctypes.c_int] * 12

    for cb in (10, 11, 12, 13):
        cp = np.ascontiguousarray(cospi_arr(cb), np.int64)
        sp = np.ascontiguousarray(sinpi_arr(cb), np.int64)
        _kept_alive.extend((cp, sp))
        lib.tputx_set_cospi(
            cb, cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))

    t = _stage_tables()
    for fwd, pfx in ((0, "i"), (1, "f")):
        for kind, kname in ((0, "dct"), (1, "adst")):
            for n in (4, 8, 16, 32, 64):
                name = f"{pfx}{kname}{n}"
                if f"{name}_nstages" not in t:
                    continue
                ns = int(t[f"{name}_nstages"])

                def cat(field, dtype):
                    arr = np.concatenate(
                        [np.asarray(t[f"{name}_s{s}_{field}"], dtype)
                         for s in range(ns)])
                    arr = np.ascontiguousarray(arr, dtype)
                    _kept_alive.append(arr)
                    return arr

                a = cat("a", np.int16)
                b = cat("b", np.int16)
                mode = cat("mode", np.uint8)
                clamp = cat("clamp", np.uint8)
                lw0 = cat("lw0", np.int32)
                lw1 = cat("lw1", np.int32)
                c0i = cat("c0i", np.int16)
                c0s = cat("c0s", np.int16)
                c1i = cat("c1i", np.int16)
                c1s = cat("c1s", np.int16)
                lib.tputx_register(
                    fwd, kind, n.bit_length() - 3, ns, n,
                    a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    b.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    mode.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    clamp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    lw0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    lw1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    c0i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    c0s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    c1i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    c1s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    _txfm_ready = True
    return lib


def fwd_txfm2d(resid: np.ndarray, tx_size: int, tx_type: int,
               bd: int = 8) -> np.ndarray:
    from svt_av1_psy_tpu.constants import TX_SIZE_HIGH, TX_SIZE_WIDE

    lib = ensure_txfms()
    w, h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
    cw, ch = min(w, 32), min(h, 32)
    r = np.ascontiguousarray(resid, np.int32)
    out = np.empty((ch, cw), np.int32)
    lib.tputx_fwd2d(r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    tx_size, tx_type, bd)
    return out


def inv_txfm2d(coeff: np.ndarray, tx_size: int, tx_type: int,
               bd: int = 8) -> np.ndarray:
    from svt_av1_psy_tpu.constants import TX_SIZE_HIGH, TX_SIZE_WIDE

    lib = ensure_txfms()
    w, h = TX_SIZE_WIDE[tx_size], TX_SIZE_HIGH[tx_size]
    c = np.ascontiguousarray(coeff, np.int32)
    out = np.empty((h, w), np.int32)
    lib.tputx_inv2d(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    tx_size, tx_type, bd)
    return out


def quantize_b(coeff: np.ndarray, tx_size: int, pq) -> tuple:
    from svt_av1_psy_tpu.ops.quant import tx_scale

    lib = ensure_txfms()
    c = np.ascontiguousarray(coeff, np.int32)
    qc = np.empty_like(c)
    dqc = np.empty_like(c)
    lib.tputx_quantize_b(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dqc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        c.size, tx_scale(tx_size),
        int(pq.zbin[0]), int(pq.zbin[1]), int(pq.round[0]), int(pq.round[1]),
        int(pq.quant[0]), int(pq.quant[1]),
        int(pq.quant_shift[0]), int(pq.quant_shift[1]),
        int(pq.dequant[0]), int(pq.dequant[1]))
    return qc, dqc
