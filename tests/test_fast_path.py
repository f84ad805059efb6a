"""Fast path (device search + native commit walk) conformance tests.

The same oracle discipline as the slow path: every stream must decode in
dav1d bit-exactly to the engine's own reconstruction (the reference's
RefDecoder gate, ref: test/e2e_test/SvtAv1E2EFramework.h:65).
"""

import numpy as np
import pytest

from svt_av1_psy_tpu.decoder.dav1d import decode_obus
from svt_av1_psy_tpu.models.fast_intra import FastIntraEncoder


def _clip(w, h, n=2, seed=3):
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        y = ((xx + yy + 8 * t) % 256).astype(np.float32)
        y += rng.normal(0, 4.0, y.shape)
        u = np.full((h // 2, w // 2), 120.0) + rng.normal(0, 2, (h // 2,
                                                                w // 2))
        v = np.full((h // 2, w // 2), 130.0) + rng.normal(0, 2, (h // 2,
                                                                w // 2))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames


@pytest.mark.parametrize("dims", [(64, 64), (352, 288), (176, 144)])
@pytest.mark.parametrize("q", [60, 120, 200])
def test_fast_intra_bitexact(dims, q):
    w, h = dims
    frames = _clip(w, h)
    enc = FastIntraEncoder(w, h, qindex=q)
    payloads, recs = [], []
    for f in frames:
        out = enc.encode_frame(*f)
        payloads.append(out.payload)
        recs.append(out)
    decoded = decode_obus(b"".join(payloads))
    assert len(decoded) == len(recs)
    for d, r in zip(decoded, recs):
        assert np.array_equal(d.y, r.recon_y)
        assert np.array_equal(d.u, r.recon_u)
        assert np.array_equal(d.v, r.recon_v)


def test_fast_intra_variance_boost():
    w, h = 176, 144
    frames = _clip(w, h, n=1)
    enc = FastIntraEncoder(w, h, qindex=120)
    enc.enable_variance_boost = True
    out = enc.encode_frame(*frames[0])
    d = decode_obus(out.payload)[0]
    assert np.array_equal(d.y, out.recon_y)
    assert np.array_equal(d.u, out.recon_u)
    assert np.array_equal(d.v, out.recon_v)


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_fast_intra_multitile_bitexact(n_tiles):
    """Multi-tile streams: per-tile contexts + tile-group assembly must
    decode bit-exact (ref: ec_process.c:208 per-tile EC)."""
    w, h = 352, 288          # boundary SB column + row
    frames = _clip(w, h)
    enc = FastIntraEncoder(w, h, qindex=100, n_tiles=n_tiles)
    assert enc.n_tiles >= 2
    payloads, recs = [], []
    for f in frames:
        out = enc.encode_frame(*f)
        payloads.append(out.payload)
        recs.append(out)
    decoded = decode_obus(b"".join(payloads))
    for d, r in zip(decoded, recs):
        assert np.array_equal(d.y, r.recon_y)
        assert np.array_equal(d.u, r.recon_u)
        assert np.array_equal(d.v, r.recon_v)


def test_fast_intra_threaded_deterministic(monkeypatch):
    """Threaded tile walks must produce byte-identical output to the
    sequential walk (the reference's REMOVE_LP1_LPN_DIFF determinism
    guard, ref API/EbDebugMacros.h)."""
    w, h = 352, 288
    frames = _clip(w, h, n=1)
    enc = FastIntraEncoder(w, h, qindex=100, n_tiles=4)
    p_thr = enc.encode_frame(*frames[0]).payload
    monkeypatch.setenv("SVT_TILE_SEQ", "1")
    enc2 = FastIntraEncoder(w, h, qindex=100, n_tiles=4)
    p_seq = enc2.encode_frame(*frames[0]).payload
    assert p_thr == p_seq


def test_fast_intra_multichip_equivalence():
    """Single-device vs 8-device-sharded decision stage must produce a
    byte-identical stream (multichip determinism — the distributed analog
    of the reference's lp1-vs-lpN guard)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    w, h = 8 * 64, 128
    frames = _clip(w, h, n=1)
    enc1 = FastIntraEncoder(w, h, qindex=100, n_tiles=8)
    p1 = enc1.encode_frame(*frames[0]).payload

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("sp",))
    enc8 = FastIntraEncoder(w, h, qindex=100, n_tiles=8)
    with mesh:
        enc8.make_sharded_decide(mesh)
        p8 = enc8.encode_frame(*frames[0]).payload
    assert p1 == p8


@pytest.mark.parametrize("n_tiles", [1, 4])
def test_fast_ippp_bitexact(n_tiles):
    """Fast low-delay path: device HME + native inter walk (MV stack, MC,
    MV coding) must produce dav1d-bit-exact P frames (ref:
    adaptive_mv_pred.c, inter_prediction.c)."""
    w, h = 352, 288
    rng = np.random.default_rng(5)
    big = rng.integers(0, 255, (h + 40, w + 40)).astype(np.uint8)
    frames = []
    for t in range(4):
        yy = np.ascontiguousarray(big[t * 3:t * 3 + h, t * 2:t * 2 + w])
        u = np.full((h // 2, w // 2), 120, np.uint8)
        frames.append((yy, u, u.copy()))
    enc = FastIntraEncoder(w, h, qindex=120, n_tiles=n_tiles)
    enc.gop_size = 0
    outs = [enc.encode_frame(*f) for f in frames]
    decoded = decode_obus(b"".join(o.payload for o in outs))
    assert len(decoded) == 4
    for d, o in zip(decoded, outs):
        assert np.array_equal(d.y, o.recon_y)
        assert np.array_equal(d.u, o.recon_u)
        assert np.array_equal(d.v, o.recon_v)
    # P frames must actually exploit motion: smaller than the key frame
    assert all(len(o.payload) < len(outs[0].payload) for o in outs[1:])


def test_fast_ippp_static_skip():
    """Static content: P frames should collapse to near-all-skip."""
    w, h = 176, 144
    frames = _clip(w, h, n=1) * 3
    enc = FastIntraEncoder(w, h, qindex=120)
    enc.gop_size = 0
    outs = [enc.encode_frame(*f) for f in frames]
    assert len(outs[1].payload) < max(len(outs[0].payload) // 2, 300)
    decoded = decode_obus(b"".join(o.payload for o in outs))
    for d, o in zip(decoded, outs):
        assert np.array_equal(d.y, o.recon_y)


def test_fast_intra_quality_sane():
    """PSNR at moderate q must be reasonable (catches silent mode bugs)."""
    import math
    w, h = 176, 144
    frames = _clip(w, h, n=1)
    enc = FastIntraEncoder(w, h, qindex=100)
    out = enc.encode_frame(*frames[0])
    d = decode_obus(out.payload)[0]
    mse = np.mean((frames[0][0].astype(np.float64) -
                   d.y.astype(np.float64)) ** 2)
    psnr = 10 * math.log10(255 * 255 / mse)
    assert psnr > 30.0, psnr


def test_fast_sharpness_and_luma_bias():
    """PSY sharpness (quant rounding bias, ref md_config_process.c:96-117)
    changes encoder-side quantization only: streams stay conformant.
    frame-luma-bias lowers q on dark P frames (ref rc_process.c:3413)."""
    rng = np.random.default_rng(1)
    y = np.zeros((288, 352), np.uint8)
    y[:, :176] = rng.integers(0, 255, (288, 176))
    y[:, 176:] = (np.arange(176) // 8 * 8).astype(np.uint8)
    u = np.full((144, 176), 128, np.uint8)
    sizes = {}
    for sh in (0, 4):
        enc = FastIntraEncoder(352, 288, qindex=160, n_tiles=1)
        enc.enable_variance_boost = True
        enc.sharpness = sh
        o = enc.encode_frame(y, u, u.copy())
        d = decode_obus(o.payload)[0]
        assert np.array_equal(d.y, o.recon_y)
        sizes[sh] = len(o.payload)
    assert sizes[4] > sizes[0]    # energy retained in boosted blocks

    dark = (y // 4).astype(np.uint8)
    enc = FastIntraEncoder(352, 288, qindex=160, n_tiles=1)
    enc.gop_size = 0
    enc.frame_luma_bias = 50
    k = enc.encode_frame(dark, u, u.copy())
    p = enc.encode_frame(dark, u, u.copy())
    dfs = decode_obus(k.payload + p.payload)
    assert np.array_equal(dfs[1].y, p.recon_y)


def test_film_grain_estimation_and_synthesis():
    """Grainy source -> estimated AR grain table signalled in the stream;
    dav1d synthesizes it (spec 5.9.30; ref noise_model.c,
    grainSynthesis.c). Pre-grain recon stays bit-exact."""
    rng = np.random.default_rng(3)
    base = np.clip(np.linspace(40, 200, 288)[:, None] +
                   np.zeros((288, 352)), 0, 255)
    y = np.clip(base + rng.normal(0, 6, (288, 352)), 0,
                255).astype(np.uint8)
    u = np.full((144, 176), 128, np.uint8)
    enc = FastIntraEncoder(352, 288, qindex=140, n_tiles=2)
    enc.gop_size = 0
    enc.film_grain = 1
    k = enc.encode_frame(y, u, u.copy())
    y2 = np.clip(base + rng.normal(0, 6, (288, 352)), 0,
                 255).astype(np.uint8)
    p = enc.encode_frame(y2, u, u.copy())
    assert enc._fg_params is not None and enc._fg_params.scaling_y
    nog = decode_obus(k.payload + p.payload, apply_grain=False)
    wg = decode_obus(k.payload + p.payload, apply_grain=True)
    assert np.array_equal(nog[0].y, k.recon_y)
    assert np.array_equal(nog[1].y, p.recon_y)
    assert not np.array_equal(wg[0].y, nog[0].y)   # grain applied

    # clean source: estimator declines to signal grain
    clean = base.astype(np.uint8)
    enc2 = FastIntraEncoder(352, 288, qindex=140, n_tiles=1)
    enc2.film_grain = 1
    enc2.encode_frame(clean, u, u.copy())
    assert enc2._fg_params is None


def test_hierarchical_lowdelay_pyramid():
    """2-level low-delay pyramid: multi-slot DPB, per-slot CDF chains,
    ref_frame_idx/refresh signalling, per-layer q (qp-scale-compress) —
    all must decode bit-exact (ref pred_structure.c; rc_process.c:777)."""
    rng = np.random.default_rng(2)
    big = rng.integers(0, 255, (340, 400)).astype(np.uint8)
    frames = [(np.ascontiguousarray(big[t * 2:t * 2 + 288,
                                        t * 3:t * 3 + 352]),
               np.full((144, 176), 128, np.uint8),
               np.full((144, 176), 128, np.uint8)) for t in range(6)]
    enc = FastIntraEncoder(352, 288, qindex=120, n_tiles=2)
    enc.gop_size = 0
    enc.hierarchical_levels = 2
    outs = [enc.encode_frame(*f) for f in frames]
    decoded = decode_obus(b"".join(o.payload for o in outs))
    assert len(decoded) == 6
    for d, o in zip(decoded, outs):
        assert np.array_equal(d.y, o.recon_y)
        assert np.array_equal(d.u, o.recon_u)


def test_fast_path_10bit():
    """Fast path at 10-bit: qtab, planes, EC, MC all bd-aware."""
    rng = np.random.default_rng(0)
    h, w = 144, 176
    y = rng.integers(0, 1023, (h, w)).astype(np.uint16)
    u = rng.integers(0, 1023, (h // 2, w // 2)).astype(np.uint16)
    v = rng.integers(0, 1023, (h // 2, w // 2)).astype(np.uint16)
    enc = FastIntraEncoder(w, h, qindex=120, bd=10, n_tiles=2)
    enc.gop_size = 0
    k = enc.encode_frame(y, u, v)
    p = enc.encode_frame(np.clip(y + 2, 0, 1023).astype(np.uint16), u, v)
    dfs = decode_obus(k.payload + p.payload)
    assert dfs[0].bit_depth == 10
    for d, o in zip(dfs, (k, p)):
        assert np.array_equal(d.y, o.recon_y)
        assert np.array_equal(d.u, o.recon_u)


def test_psy_rd_energy_preservation():
    """psy-rd (transform-domain AC energy term, the psy_rd.c analog):
    higher strength keeps more high-frequency energy; conformant."""
    rng = np.random.default_rng(1)
    y = np.zeros((288, 352), np.uint8)
    y[:, :176] = rng.integers(0, 255, (288, 176))
    y[:, 176:] = (np.arange(176) // 8 * 8).astype(np.uint8)
    u = np.full((144, 176), 128, np.uint8)
    res = {}
    for pr in (0.0, 4.0):
        # n_cands=2 keeps the angle-delta search out: the energy
        # comparison isolates the psy quant/RD term
        enc = FastIntraEncoder(352, 288, qindex=160, n_tiles=1,
                               n_cands=2)
        enc.psy_rd = pr
        o = enc.encode_frame(y, u, u.copy())
        d = decode_obus(o.payload)[0]
        assert np.array_equal(d.y, o.recon_y)
        res[pr] = np.abs(np.diff(d.y.astype(int), axis=1)).sum()
    assert res[4.0] >= res[0.0]


def test_temporal_filter_denoises_keys():
    """Alt-ref temporal filtering (ref temporal_filtering.c): MC-aligned
    window blending reduces key-frame noise without smearing motion."""
    from svt_av1_psy_tpu.models.temporal_filter import temporal_filter
    rng = np.random.default_rng(0)
    h, w = 144, 176
    base = np.clip(np.linspace(30, 220, h)[:, None] + np.zeros((h, w)),
                   0, 255)
    frames = []
    for t in range(5):
        y = np.clip(base + rng.normal(0, 8, (h, w)), 0,
                    255).astype(np.uint8)
        u = np.clip(128 + rng.normal(0, 4, (h // 2, w // 2)), 0,
                    255).astype(np.uint8)
        frames.append((y, u, u.copy()))
    fy, fu, fv = temporal_filter(frames, 2, strength=2)
    before = (frames[2][0].astype(float) - base).std()
    after = (fy.astype(float) - base).std()
    assert after < before * 0.9


def test_scene_cut_forces_key():
    """scene_change_detection (scd, ref pic_analysis_process.c): a hard
    content cut inside an open GOP forces a key frame and realigns the
    GOP; the stream stays dav1d bit-exact."""
    rng = np.random.default_rng(9)

    def frame(seed):
        r = np.random.default_rng(seed)
        return (r.integers(0, 255, (144, 176)).astype(np.uint8),
                r.integers(0, 255, (72, 88)).astype(np.uint8),
                r.integers(0, 255, (72, 88)).astype(np.uint8))

    base = frame(1)
    clip = []
    for _ in range(4):
        y = np.clip(base[0].astype(np.int16)
                    + rng.integers(-3, 4, base[0].shape), 0,
                    255).astype(np.uint8)
        clip.append((y, base[1], base[2]))
    clip += [frame(99), frame(99)]          # hard cut at frame 4
    enc = FastIntraEncoder(176, 144, qindex=120)
    enc.gop_size = 0                        # open GOP: only frame 0 key
    enc.enable_scenecut = True
    sizes, recons, payload = [], [], b""
    for f in clip:
        o = enc.encode_frame(*f)
        payload += o.payload
        recons.append(o.recon_y)
        sizes.append(len(o.payload))
    for d, r in zip(decode_obus(payload), recons):
        assert np.array_equal(d.y, r)
    assert sizes[4] > 2.0 * sizes[3]        # cut frame intra-coded
    assert sizes[5] < 0.7 * sizes[4]        # next frame P again


def test_angle_delta_search():
    """Luma angle-delta refinement (spec 5.11.42; presets <= 11): on
    off-axis directional content some blocks must pick a nonzero delta,
    the stream stays dav1d bit-exact, and RD improves vs delta=0."""
    yy, xx = np.mgrid[0:288, 0:352]
    rng = np.random.default_rng(3)
    y = np.clip(128 + 60 * np.sin((xx + 2.37 * yy) / 17.0) +
                rng.normal(0, 3, (288, 352)), 0, 255).astype(np.uint8)
    u = np.full((144, 176), 128, np.uint8)
    enc = FastIntraEncoder(352, 288, qindex=140, n_cands=3)
    o = enc.encode_frame(y, u, u.copy())
    d = decode_obus(o.payload)[0]
    assert np.array_equal(d.y, o.recon_y)
    assert np.array_equal(d.u, o.recon_u)
    # parse and count nonzero angle deltas
    from svt_av1_psy_tpu.decoder.driver import Decoder
    import svt_av1_psy_tpu.decoder.tile_parser as tp
    deltas = []
    orig = tp.TileParser.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        inner = self._sym

        def wrap(name, cdf, *rest, **kw):
            v = inner(name, cdf, *rest, **kw)
            if name.startswith("angle_y"):
                deltas.append(v - 3)
            return v
        self._sym = wrap

    tp.TileParser.__init__ = spy
    try:
        dd = Decoder()
        dd.decode_temporal_unit(o.payload)
    finally:
        tp.TileParser.__init__ = orig
    assert np.array_equal(dd.frames[0].y, o.recon_y)
    assert any(d_ != 0 for d_ in deltas), "no nonzero angle deltas chosen"


def test_tx_split_search():
    """Depth-1 TX split search (TX_MODE_SELECT, spec 5.11.15): detailed
    content must pick sub-block TXs, stay dav1d bit-exact, and improve
    RD vs largest-TX."""
    yy, xx = np.mgrid[0:288, 0:352]
    rng = np.random.default_rng(3)
    y = np.clip(128 + 55 * np.sin((xx + 2.1 * yy) / 13.0) +
                22 * np.sin(xx * yy / 900.0) +
                rng.normal(0, 4, (288, 352)), 0, 255).astype(np.uint8)
    u = np.full((144, 176), 128, np.uint8)
    enc = FastIntraEncoder(352, 288, qindex=120, n_cands=2)
    enc.tx_split_search = True
    o = enc.encode_frame(y, u, u.copy())
    d = decode_obus(o.payload)[0]
    assert np.array_equal(d.y, o.recon_y)
    assert np.array_equal(d.u, o.recon_u)
    # some blocks must choose tx < block size
    from svt_av1_psy_tpu.decoder.driver import Decoder
    import svt_av1_psy_tpu.decoder.tile_parser as tp
    found = []
    orig = tp.ParsedBlock.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        found.append((self.bsize, self.tx_size))

    tp.ParsedBlock.__init__ = spy
    try:
        dd = Decoder()
        dd.decode_temporal_unit(o.payload)
    finally:
        tp.ParsedBlock.__init__ = orig
    assert np.array_equal(dd.frames[0].y, o.recon_y)
    maxtx = {3: 1, 6: 2, 9: 3, 12: 4}
    nsplit = sum(1 for bs, ts in found if ts != maxtx.get(bs, -1))
    assert nsplit > 0, "no TX splits chosen"
