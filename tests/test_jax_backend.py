"""Device (JAX/XLA) vs numpy trusted-path equivalence.

The device analog of the reference's C-vs-SIMD bit-exactness harness
(ref: test/SadTest.cc pattern — randomized buffers, exact compare,
SURVEY.md §4.1). Runs on the virtual CPU backend in CI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svt_av1_psy_tpu.constants import TX_SIZE_HIGH, TX_SIZE_WIDE, TxSize
from svt_av1_psy_tpu.ops import jax_backend as jb
from svt_av1_psy_tpu.ops import transforms as txn
from svt_av1_psy_tpu.ops.intra import SUPPORTED_MODES, predict, prepare_edges
from svt_av1_psy_tpu.ops.quant import build_plane_quant, qm_matrix, iqm_matrix, quantize_b

TX_CASES = [(ts, bd) for ts in (0, 1, 2, 3, 4, 5, 8, 9, 12, 16)
            for bd in (8, 10)]


@pytest.mark.parametrize("ts,bd", TX_CASES)
def test_transform_roundtrip_device_equals_numpy(ts, bd):
    rng = np.random.default_rng(ts * 31 + bd)
    w, h = TX_SIZE_WIDE[ts], TX_SIZE_HIGH[ts]
    resid = rng.integers(-(1 << bd) + 1, 1 << bd, (8, h, w)).astype(np.int32)
    cn = txn.forward_transform_2d(resid, ts, 0, bd)
    cj = np.asarray(jb.forward_transform_batch(jnp.asarray(resid), ts, 0, bd))
    np.testing.assert_array_equal(cn, cj)
    inv_n = txn.inverse_transform_2d(cn, ts, 0, bd)
    inv_j = np.asarray(jb.inverse_transform_batch(jnp.asarray(cn), ts, 0, bd))
    np.testing.assert_array_equal(inv_n, inv_j)


@pytest.mark.parametrize("ts,bd", TX_CASES)
def test_quantize_device_equals_numpy(ts, bd):
    rng = np.random.default_rng(ts * 17 + bd)
    w, h = min(TX_SIZE_WIDE[ts], 32), min(TX_SIZE_HIGH[ts], 32)
    for q in (20, 100, 255):
        coeff = rng.integers(-(1 << 18), 1 << 18, (4, h, w)).astype(np.int32)
        pq = build_plane_quant(q, bd=bd)
        qn, dqn = quantize_b(coeff, ts, pq)
        qj, dqj = jb.quantize_b_batch(jnp.asarray(coeff), ts, pq)
        np.testing.assert_array_equal(qn, np.asarray(qj))
        np.testing.assert_array_equal(dqn, np.asarray(dqj))


def test_quantize_qm_device_equals_numpy():
    rng = np.random.default_rng(5)
    ts = int(TxSize.TX_16X16)
    qm = qm_matrix(8, 0, ts)
    iqm = iqm_matrix(8, 0, ts)
    coeff = rng.integers(-(1 << 16), 1 << 16, (4, 16, 16)).astype(np.int32)
    pq = build_plane_quant(120)
    qn, dqn = quantize_b(coeff, ts, pq, qm=qm, iqm=iqm)
    qj, dqj = jb.quantize_b_batch(jnp.asarray(coeff), ts, pq, qm=qm, iqm=iqm)
    np.testing.assert_array_equal(qn, np.asarray(qj))
    np.testing.assert_array_equal(dqn, np.asarray(dqj))


def test_batched_intra_predictors_match_scalar():
    rng = np.random.default_rng(9)
    n, w, h = 12, 64, 64
    recon = rng.integers(0, 256, (256, 256)).astype(np.uint8)
    cases = [(64, 64, True, True), (0, 64, False, True), (64, 0, True, False),
             (0, 0, False, False)]
    above = np.zeros((len(cases), w), np.int32)
    left = np.zeros((len(cases), h), np.int32)
    al = np.zeros(len(cases), np.int32)
    ha = np.zeros(len(cases), bool)
    hl = np.zeros(len(cases), bool)
    refs = []
    for i, (x, y, a_ok, l_ok) in enumerate(cases):
        ab, lf, aal = prepare_edges(recon, x, y, w, h, a_ok, l_ok)
        above[i], left[i], al[i] = ab, lf, aal
        ha[i], hl[i] = a_ok, l_ok
        refs.append([predict(int(m), ab, lf, aal, w, h, a_ok, l_ok)
                     for m in SUPPORTED_MODES])
    out = np.asarray(jb.predict_modes_batch(
        jnp.asarray(above), jnp.asarray(left), jnp.asarray(al),
        jnp.asarray(ha), jnp.asarray(hl), w, h))
    for i in range(len(cases)):
        for mi in range(len(SUPPORTED_MODES)):
            np.testing.assert_array_equal(out[i, mi], refs[i][mi],
                                          err_msg=f"case {i} mode {mi}")


def test_sb_mode_costs_jits_and_is_sane():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 255, (128, 192)).astype(np.uint8)
    costs, best = jax.jit(jb.sb_mode_costs)(jnp.asarray(y, jnp.int32))
    assert costs.shape == (6, 7)
    assert (np.asarray(costs) >= 0).all()
    assert np.asarray(best).shape == (6,)
