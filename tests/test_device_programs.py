"""Device search programs against plain numpy references, on the CPU.

- hme_search against an exhaustive numpy SAD search (bit-exact);
- hme_search2 (hierarchical, not exhaustive) against the exhaustive
  search over its whole reach: its SADs are the true SADs at its MVs,
  never below the exhaustive minimum, and it finds a global translation;
- tf_filter_device against the host temporal filter;
- DeviceLrSearch (Gram products at full precision) against the float64
  search_lr_frame;
- the cross-backend harness (utils/parity.py) on two CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svt_av1_psy_tpu.ops.jax_backend import (hme_search, hme_search2,
                                             tf_filter_device)
from svt_av1_psy_tpu.utils import parity


def _half(p):
    p = np.asarray(p, np.int64)
    return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] +
            p[1::2, 1::2] + 2) >> 2


def _block_sads(sh, rp, dy, dx, pad):
    """Half-res 8x8 SADs of sh against the edge-padded rp at (dy, dx)."""
    hh, wh = sh.shape
    win = rp[pad + dy:pad + dy + hh, pad + dx:pad + dx + wh]
    return np.abs(sh - win).reshape(hh // 8, 8, wh // 8, 8).sum((1, 3))


def _exhaustive(sh, rh, reach):
    """Raster-order full search over +-reach half-res px, strict-less
    updates (the first minimum wins). Returns (mv half-res, sad)."""
    rp = np.pad(rh, reach, mode="edge")
    best = np.full((sh.shape[0] // 8, sh.shape[1] // 8),
                   np.iinfo(np.int64).max)
    mv = np.zeros(best.shape + (2,), np.int64)
    for dy in range(-reach, reach + 1):
        for dx in range(-reach, reach + 1):
            sad = _block_sads(sh, rp, dy, dx, reach)
            better = sad < best
            best = np.where(better, sad, best)
            mv[better] = (dy, dx)
    return mv, best


def _textured_pair(h, w, shift, seed):
    """(src, ref) lumas: smooth texture, src = ref translated by shift
    (full-pel; src[y, x] = ref[y + dy, x + dx]) plus mild noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(float)
    ref = np.kron(coarse, np.ones((8, 8)))[:h, :w]
    ref = (ref + np.roll(ref, 3, 0) + np.roll(ref, 3, 1)) / 3
    ref = np.clip(ref + rng.normal(0, 3, ref.shape), 0, 255)
    src = np.roll(ref, (-shift[0], -shift[1]), (0, 1))
    src = np.clip(src + rng.normal(0, 2, src.shape), 0, 255)
    return src.astype(np.uint8), ref.astype(np.uint8)


def test_hme_search_matches_exhaustive_numpy():
    src, ref = _textured_pair(144, 176, (6, -10), seed=3)
    mv, sad = jax.device_get(hme_search(jnp.asarray(src), jnp.asarray(ref),
                                        search_range=12))
    bmv, bsad = _exhaustive(_half(src), _half(ref), 12)
    assert np.array_equal(np.asarray(mv), 2 * bmv)
    assert np.array_equal(np.asarray(sad), bsad)


def test_hme_search2_against_exhaustive_numpy():
    shift = (10, -14)                       # full-pel, inside the reach
    src, ref = _textured_pair(144, 176, shift, seed=5)
    mv, sad = [np.asarray(a) for a in jax.device_get(
        hme_search2(jnp.asarray(src), jnp.asarray(ref)))]
    sh, rh = _half(src), _half(ref)
    reach = 2 * 16 + 7                      # 2*r0 + r1 half-res px
    rp = np.pad(rh, reach, mode="edge")
    # the returned SAD is the true SAD at the returned MV, block by block
    mvh = mv.astype(np.int64) // 2
    for r in range(mv.shape[0]):
        for c in range(mv.shape[1]):
            dy, dx = mvh[r, c]
            assert _block_sads(sh, rp, dy, dx, reach)[r, c] == sad[r, c]
    # never below the exhaustive minimum over its whole reach
    _, bsad = _exhaustive(sh, rh, reach)
    assert (sad >= bsad).all()
    # and it finds the translation on the interior blocks
    inner = (slice(1, -1), slice(1, -1))
    hit = (mv[inner] == np.asarray(shift)).all(-1)
    assert hit.mean() >= 0.9, hit.mean()
    assert np.array_equal(sad[inner][hit], bsad[inner][hit])


def test_tf_filter_device_matches_host_filter():
    """Same window, same MVs (both run hme_search2): the device filter
    agrees with the host one within the cross-backend TF tolerance: the
    host weighs blocks in float64, the device in float32."""
    from svt_av1_psy_tpu.models.temporal_filter import temporal_filter

    h, w, T = 144, 176, 5
    lumas = parity.make_lumas(T, h, w, seed=9)
    chroma = parity.make_lumas(2 * T, h // 2, w // 2, seed=10)
    frames = [(lumas[t], chroma[t], chroma[T + t]) for t in range(T)]
    center = T - 1
    host = temporal_filter(frames, center, strength=1)
    dev = tf_filter_device(
        jnp.asarray(lumas), jnp.asarray(chroma[:T]),
        jnp.asarray(chroma[T:]), jnp.ones(T, jnp.float32),
        jnp.asarray(np.float32(1.0)), 8)
    parity._tf_compare("tf_filter_device vs host", jax.device_get(dev),
                       host, (T, h, w))


def test_device_lr_search_matches_float64_search():
    from svt_av1_psy_tpu.models.lr_search import (DeviceLrSearch,
                                                  search_lr_frame)

    h, w = 128, 192
    res = parity.check_lr(jax.devices("cpu")[0], h, w)
    assert res["max_tap_diff"] <= parity.LR_TAP_TOL
    # the decisions the encoder signals: same planes on, same units on
    src, rec = parity._lr_inputs(h, w, seed=8)
    dims = [(w, h), (w // 2, h // 2), (w // 2, h // 2)]
    search = DeviceLrSearch(dims, bd=8)
    dec = search.finish(search.dispatch(src, rec), 60.0)
    ref = search_lr_frame(src, rec, dims, 60.0, bd=8)
    assert ref is not None and dec is not None
    assert dec.lr_type == ref.lr_type
    for plane in range(3):
        assert {k: u["type"] for k, u in dec.units[plane].items()} == \
            {k: u["type"] for k, u in ref.units[plane].items()}


@pytest.mark.parametrize("check, extra", [
    (parity.check_intra_decide, (8,)), (parity.check_intra_decide, (10,)),
    (parity.check_hme, ()), (parity.check_gop_search, ()),
    (parity.check_gop_search_tf, ()), (parity.check_tf_filter, ()),
    (parity.check_block_mode_costs, ())],
    ids=["intra_decide_u8", "intra_decide_u16", "hme", "gop_search",
         "gop_search_tf", "tf_filter", "block_mode_costs"])
def test_parity_harness_on_two_cpu_devices(check, extra):
    """The cross-backend checks chip_smoke.py runs on the card, here
    between two virtual CPU devices (identical by construction: this
    exercises the harness itself)."""
    d0, d1 = jax.devices("cpu")[:2]
    out = check(d1, d0, 128, 192, *extra)
    assert out.get("bit_exact", True)
    assert out.get("max_abs_diff", 0) == 0
