"""Cross-backend checks of the device search programs.

Each check runs one program of the encode path on a device under test and
on a reference device (the CPU) with the same inputs, and compares:

- the integer programs (intra decide, HME, SAD tree, GoP search, the
  round-1 block mode costs) bit for bit;
- the temporal filter within max |d| <= 1 code value and >= 99.9 % of
  samples equal: it weighs blocks with f32 exp and sums in f32, and a GPU
  rounds and orders those sums differently from the CPU;
- the Wiener LR search against the float64 numpy search: taps within
  +-1, and each unit's on/off decision equal except where its two RD
  costs lie within 1e-4 of each other.

A failed comparison raises AssertionError. Each check returns a short
summary dict. chip_smoke.py runs the checks at 1080p; the card-only
tests (pytest marker gpu) run them at a small size.
"""

from __future__ import annotations

import functools

import numpy as np

TF_MAX_ABS = 1
TF_MIN_EQUAL = 0.999
LR_TAP_TOL = 1
LR_TIE_REL = 1e-4


def make_lumas(n: int, h: int, w: int, bd: int = 8, seed: int = 0):
    """(n, h, w) test lumas: a textured background panning 3 px right
    and 2 px down per frame, a flat band (SAD ties) and mild noise."""
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    bg = rng.integers(0, hi + 1, (h // 8 + 8, w // 8 + 8))
    bg = np.kron(bg, np.ones((8, 8))) * 0.6 + \
        rng.normal(0, 0.05 * hi, (bg.shape[0] * 8, bg.shape[1] * 8))
    out = np.empty((n, h, w), np.uint8 if bd == 8 else np.uint16)
    for t in range(n):
        f = bg[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        f[h // 3:h // 3 + h // 8, :] = hi // 2         # flat band
        f += rng.normal(0, 0.01 * hi, f.shape)
        out[t] = np.clip(f, 0, hi).astype(out.dtype)
    return out


def _on(device, fn, *args):
    """Run fn(*args) with args placed on device; numpy results."""
    import jax

    with jax.default_device(device):
        out = fn(*[jax.device_put(a, device) for a in args])
        return jax.tree_util.tree_map(np.asarray, jax.device_get(out))


def _both(dev, ref, fn, *args):
    """fn on both devices, compiled and run concurrently."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as ex:
        fa = ex.submit(_on, dev, fn, *args)
        fb = ex.submit(_on, ref, fn, *args)
        return fa.result(), fb.result()


def _equal(name, a, b, shape):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), name
    for x, y in zip(la, lb):
        assert x.shape == y.shape and np.array_equal(x, y), \
            f"{name} {shape}: device and reference differ " \
            f"({int(np.sum(x != y)) if x.shape == y.shape else 'shape'})"
    return {"program": name, "shape": list(shape), "bit_exact": True}


def _leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def check_intra_decide(dev, ref, h, w, bd):
    """intra_decide_packed at bit depth bd (uint8 at 8, else uint16)."""
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import intra_decide_packed
    from svt_av1_psy_tpu.ops.quant import ac_q

    y = make_lumas(1, h, w, bd, seed=1)[0]
    bias = np.int32(8 * ac_q(120, bd))
    fn = jax.jit(functools.partial(intra_decide_packed, bd=bd, min_block=8))
    a, b = _both(dev, ref, fn, y, bias)
    return _equal(f"intra_decide_packed u{y.dtype.itemsize * 8}", a, b,
                  (h, w))


def check_hme(dev, ref, h, w):
    """hme_search2 and hme_sad_tree at its MVs, on one edge."""
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import hme_sad_tree, hme_search2

    fr = make_lumas(2, h, w, seed=2)

    def hme(src, ref_):
        mv, sad = hme_search2(src, ref_)
        return (mv, sad) + hme_sad_tree(src, ref_, mv)

    a, b = _both(dev, ref, jax.jit(hme), fr[1], fr[0])
    return _equal("hme_search2 + hme_sad_tree", a, b, (h, w))


def _edges(n_frames, n_edges):
    e = [(s, r) for s in range(1, n_frames) for r in range(n_frames)
         if r != s]
    return np.asarray((e * n_edges)[:n_edges], np.int32)


def check_gop_search(dev, ref, h, w, n_frames=3, n_edges=8):
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import gop_search

    fr = make_lumas(n_frames, h, w, seed=3)
    fn = jax.jit(gop_search, static_argnums=(3, 4))
    args = (fr, _edges(n_frames, n_edges), np.int32(400))
    a, b = _both(dev, ref, lambda *x: fn(*x, 8, 8), *args)
    return _equal("gop_search", a, b, (n_frames, h, w))


def check_block_mode_costs(dev, ref, h, w):
    """The round-1 per-size mode search (presets <= 3, screen keys)."""
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import block_mode_costs

    y = make_lumas(1, h, w, seed=4)[0]
    fn = jax.jit(functools.partial(block_mode_costs, size=16, bd=8))
    a, b = _both(dev, ref, fn, y)
    return _equal("block_mode_costs", a, b, (h, w))


def _tf_compare(name, a, b, shape):
    """The temporal-filter tolerance over a list of plane pairs."""
    n = neq = 0
    worst = 0
    for x, y in zip(a, b):
        d = np.abs(np.asarray(x, np.int64) - np.asarray(y, np.int64))
        worst = max(worst, int(d.max()))
        n += d.size
        neq += int(np.count_nonzero(d))
    frac = 1.0 - neq / n
    assert worst <= TF_MAX_ABS and frac >= TF_MIN_EQUAL, \
        f"{name} {shape}: max |d| {worst}, {frac:.6f} of samples equal"
    return {"program": name, "shape": list(shape), "max_abs_diff": worst,
            "frac_equal": frac}


def _tf_window(T, h, w, seed):
    fr = make_lumas(T, h, w, seed=seed)
    ch = make_lumas(2 * T, h // 2, w // 2, seed=seed + 1)
    return fr, ch[:T], ch[T:]


def check_tf_filter(dev, ref, h, w, T=5):
    """tf_filter_device (with _tf_align) on a T-frame window."""
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import tf_filter_device

    wy, wu, wv = _tf_window(T, h, w, seed=5)
    mask = np.ones(T, np.float32)
    fn = jax.jit(tf_filter_device, static_argnums=(5,))
    args = (wy, wu, wv, mask, np.float32(1.0))
    a, b = _both(dev, ref, lambda *x: fn(*x, 8), *args)
    return _tf_compare(f"tf_filter_device T={T}", a, b, (T, h, w))


def check_gop_search_tf(dev, ref, h, w, n_frames=3, n_edges=8):
    """gop_search_tf: the filtered anchors within the TF tolerance, and
    the search payload bit-exact against gop_search run on the
    reference with the device's own filtered anchors in the stack."""
    import jax

    from svt_av1_psy_tpu.ops.jax_backend import (gop_search, gop_search_tf,
                                                 gop_search_tf_unpack)

    T = 5
    fr = make_lumas(n_frames, h, w, seed=6)
    ch = make_lumas(4 * T, h // 2, w // 2, seed=7)
    edges = _edges(n_frames, n_edges)
    win_idx = np.array([0, 2, 0, 0, 1], np.int32)     # ARF at slot 1
    win_mask = np.array([1, 1, 0, 0, 1], np.float32)
    win2_idx = np.array([0, 1, 0, 0, 2], np.int32)    # mid at slot 2
    win2_mask = np.array([1, 1, 0, 0, 1], np.float32)
    args = (fr, edges, np.int32(400), ch[:T], ch[T:2 * T], win_idx,
            win_mask, np.float32(1.0))
    args2 = (ch[2 * T:3 * T], ch[3 * T:], win2_idx, win2_mask)
    fn = jax.jit(gop_search_tf, static_argnums=(8, 9))

    def run(*x):
        return fn(*x[:8], 8, 8, *x[8:])

    a, b = _both(dev, ref, run, *args, *args2)
    ua = gop_search_tf_unpack(a, n_frames, n_edges, (h, w), 8, 2)
    ub = gop_search_tf_unpack(b, n_frames, n_edges, (h, w), 8, 2)
    planes_a = [p for trio in ua[5] for p in trio]
    planes_b = [p for trio in ub[5] for p in trio]
    out = _tf_compare("gop_search_tf filtered anchors", planes_a,
                      planes_b, (n_frames, h, w))
    stack = fr.copy()
    stack[1], stack[2] = ua[5][0][0], ua[5][1][0]
    gs = jax.jit(gop_search, static_argnums=(3, 4))
    c = _on(ref, lambda *x: gs(*x, 8, 8), stack, edges, np.int32(400))
    assert np.array_equal(a[:c.size], c), \
        "gop_search_tf search payload differs from gop_search on the " \
        "same filtered anchors"
    out["search_bit_exact"] = True
    out["anchors_equal"] = bool(all(np.array_equal(x, y) for x, y in
                                    zip(planes_a, planes_b)))
    return out


def _lr_inputs(h, w, seed):
    """Source planes and a blurred, noisy 'recon' of them (4:2:0)."""
    rng = np.random.default_rng(seed)
    src = [make_lumas(1, h, w, seed=seed)[0]] + \
        [make_lumas(1, h // 2, w // 2, seed=seed + k)[0] for k in (1, 2)]
    rec = []
    for p in src:
        f = p.astype(np.float64)
        f = (np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1) +
             np.roll(f, -1, 1) + 4 * f) / 8 + rng.normal(0, 1.5, f.shape)
        rec.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return src, rec


def check_lr(dev, h, w, rdmult=60.0):
    """DeviceLrSearch on dev against the float64 numpy search."""
    import jax

    from svt_av1_psy_tpu.models.lr_search import (_BITS_NONE, _BITS_WIENER,
                                                  DeviceLrSearch,
                                                  _unit_grid, _unit_sums,
                                                  solve_wiener_plane)

    src, rec = _lr_inputs(h, w, seed=8)
    dims = [(w, h), (w // 2, h // 2), (w // 2, h // 2)]
    search = DeviceLrSearch(dims, bd=8)
    with jax.default_device(dev):
        buf = np.asarray(search.dispatch(src, rec))
    off = 0
    worst_tap = 0
    n_units = n_on = n_flip = 0
    for plane in range(3):
        pw, ph = dims[plane]
        urows, ucols, ys, xs = _unit_grid(pw, ph, search.unit_size[plane],
                                          8 >> (1 if plane else 0))
        n = urows * ucols
        taps_d = buf[off:off + 6]
        sse_nd = buf[off + 6:off + 6 + n].reshape(urows, ucols)
        sse_wd = buf[off + 6 + n:off + 6 + 2 * n].reshape(urows, ucols)
        off += 6 + 2 * n
        S = src[plane].astype(np.float64)
        R = rec[plane].astype(np.float64)
        vt, ht, F = solve_wiener_plane(R, S, chroma=plane > 0)
        worst_tap = max(worst_tap, int(np.abs(
            taps_d - np.asarray(vt + ht, np.float64)).max()))
        sse_n = _unit_sums((R - S) ** 2, ys, xs)
        sse_w = _unit_sums((np.clip(np.rint(F), 0, 255) - S) ** 2, ys, xs)
        cw, cn = sse_w + rdmult * _BITS_WIENER, sse_n + rdmult * _BITS_NONE
        cwd = sse_wd + rdmult * _BITS_WIENER
        cnd = sse_nd + rdmult * _BITS_NONE
        flip = (cwd < cnd) != (cw < cn)
        tie = np.abs(cw - cn) <= LR_TIE_REL * np.maximum(cw, cn)
        assert not (flip & ~tie).any(), \
            f"DeviceLrSearch plane {plane} ({h}x{w}): " \
            f"{int((flip & ~tie).sum())} unit decisions differ"
        n_units += n
        n_on += int((cw < cn).sum())
        n_flip += int(flip.sum())
    assert worst_tap <= LR_TAP_TOL, \
        f"DeviceLrSearch ({h}x{w}): taps differ by {worst_tap}"
    return {"program": "DeviceLrSearch vs float64 numpy",
            "device": str(dev), "shape": [h, w], "max_tap_diff": worst_tap,
            "units": n_units, "units_on": n_on, "tie_flips": n_flip}


def check_all(dev, ref, h, w):
    """Every check at padded size (h, w): dev against ref (the CPU)."""
    return [check_intra_decide(dev, ref, h, w, 8),
            check_intra_decide(dev, ref, h, w, 10),
            check_hme(dev, ref, h, w),
            check_gop_search(dev, ref, h, w),
            check_gop_search_tf(dev, ref, h, w),
            check_tf_filter(dev, ref, h, w),
            check_block_mode_costs(dev, ref, h, w),
            check_lr(dev, h, w),
            check_lr(ref, h, w)]
