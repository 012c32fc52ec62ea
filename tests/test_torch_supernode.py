"""PyTorch port vs the JAX reference: the supernodal panel kernels.

Each plain version (``repro_torch.kernels.ref``: ``sn_panel_factor_ref``,
``sn_schur_ref``, ``sn_trsv_ref``, ``sn_pair_det``, and the in-place forms
``sn_panel_factor_inplace_ref`` / ``sn_schur_inplace_ref`` that read and
write a factor vector through slot tables) against the reference's Pallas
kernel run with ``interpret=True`` on the same numpy inputs — ragged lanes
(w < wb, r < rb), an all-pad lane, NaN-free garbage in every pad slot,
static 2x2 pivot pairs, and sibling lanes whose extend-add targets
overlap.  The plain sweep step ``sn_sweep_inplace_ref`` against the
reference's ``_sn_sweep_fn`` with its jnp oracle and with the Pallas
``block_trsv`` in interpret mode.  Errors are measured against the
output's scale (max |reference|; for the GEMM the product of |inputs|):
1e-12 in f64, 1e-5 in f32.  The hand-written kernels are held to these
plain versions on a card by ``test_torch_on_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.direct import _sn_sweep_fn
from repro.kernels import ref as rref
from repro.kernels import supernode as rsn
from repro_torch.kernels import ref as tref
from repro_torch.kernels import supernode as tsn

from _torch_parity import (inplace_bucket, np_of, panel_bucket, port_inplace,
                           port_panel, rel, sweep_bucket, sweep_bucket_on)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(3, 8, 16), (5, 4, 8), (4, 2, 4), (2, 8, 32)]   # (k, wb, rb)
MODES = ("l", "lt", "u", "ut")


def _ref_inplace(b, tau, pairs, guard=True):
    """The reference's Pallas kernels on the gathered panels, written back
    into copies of C: (C after panel_factor, nbad, C after the extend-add
    C[tgt] -= S of the live entries)."""
    C, pidx, qidx, pm, qm = b["C"], b["pidx"], b["qidx"], b["pm"], b["qm"]
    Pr, Qr, nr = _ref_panel(C[pidx], C[qidx], b["w"], b["r"], tau, b["bkm"],
                            pairs, guard)
    Pr, Qr = np.asarray(Pr), np.asarray(Qr)
    Cf = C.copy()
    Cf[pidx[pm]], Cf[qidx[qm]] = Pr[pm], Qr[qm]
    S = np.asarray(rsn.schur_update(jnp.asarray(Pr), jnp.asarray(Qr),
                                    interpret=True))
    live = np.concatenate([S[l, :rl, :rl].reshape(-1)
                           for l, rl in enumerate(b["r"])])
    Cs = Cf.copy()
    np.subtract.at(Cs, b["tgt"], live)
    return Cf, float(nr), Cs


def _ref_panel(P, Q, w, r, tau, bkm, pairs, guard):
    return rsn.panel_factor(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w),
                            jnp.asarray(r), tau, jnp.asarray(bkm),
                            pairs=pairs, guard=guard, interpret=True)


def test_pair_det_matches_reference():
    rng = np.random.default_rng(0)
    a, b, c, e = rng.normal(size=(4, 64))
    a[:8] = b[:8] = c[:8] = e[:8] = 0.0            # det 0 → clamped floor
    b[8:16], c[8:16] = a[8:16], e[8:16]            # det exactly 0 of scale
    for dt in (np.float64, np.float32):
        args = [x.astype(dt) for x in (a, b, c, e)]
        dr, br = rref.sn_pair_det(*[jnp.asarray(x) for x in args])
        dtt, bt = tref.sn_pair_det(*[torch.tensor(x) for x in args])
        np.testing.assert_array_equal(np_of(bt), np.asarray(br))
        np.testing.assert_array_equal(np_of(dtt), np.asarray(dr))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_panel_factor_plain_matches_reference(shape, pairs, dtype):
    k, wb, rb = shape
    P, Q, w, r, bkm = panel_bucket(k, wb, rb, dtype, 11 + wb, pairs)
    tau = 0.5
    Pr, Qr, nr = _ref_panel(P, Q, w, r, tau, bkm, pairs, True)
    Pt, Qt, nt = port_panel(P, Q, w, r, tau, bkm, pairs, True)
    assert rel(Pt, Pr) <= TOL[dtype]
    assert rel(Qt, Qr) <= TOL[dtype]
    assert float(nt) == float(nr)
    if pairs:
        assert float(nt) == 0.0                    # pairs cover the zeros


def test_panel_factor_guard_off_and_clamp_count_match_reference():
    P, Q, w, r, bkm = panel_bucket(4, 8, 8, np.float64, 3, False)
    P[0, 0, 0] = 1e-14                             # a clamped 1x1 pivot
    for guard in (True, False):
        Pr, Qr, nr = _ref_panel(P, Q, w, r, 1e-6, bkm, False, guard)
        Pt, Qt, nt = port_panel(P, Q, w, r, 1e-6, bkm, False, guard)
        assert float(nt) == float(nr) == (1.0 if guard else 0.0)
        assert rel(Pt, Pr) <= 1e-12 and rel(Qt, Qr) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_schur_plain_matches_reference(shape, dtype):
    k, wb, rb = shape
    P, Q, w, r, bkm = panel_bucket(k, wb, rb, dtype, 5, False)
    Sr = rsn.schur_update(jnp.asarray(P), jnp.asarray(Q), interpret=True)
    St = tref.sn_schur_ref(torch.tensor(P), torch.tensor(Q))
    scale = tref.sn_schur_ref(torch.tensor(np.abs(P)), torch.tensor(np.abs(Q)))
    assert St.shape == (k, rb, rb)
    assert rel(St, Sr, scale) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("shape", [(5, 4, 8), (3, 8, 16), (7, 3, 5)])
def test_inplace_plain_matches_reference(shape, pairs, dtype):
    """panel_factor and the fused schur_update in place in C, through slot
    tables whose pads all name one sink slot: every slot of C as the
    reference leaves it (gather, Pallas kernel, scatter, C[tgt] -= S), the
    same clamp count, and the sink never written."""
    k, wb, rb = shape
    b = inplace_bucket(k, wb, rb, dtype, 21 + wb, pairs)
    Cf_r, nr, Cs_r = _ref_inplace(b, 0.5, pairs)
    Cf_t, nt, Cs_t = port_inplace(b, 0.5, pairs)
    assert rel(Cf_t, Cf_r) <= TOL[dtype]
    assert rel(Cs_t, Cs_r) <= TOL[dtype]
    assert nt == nr
    assert float(Cs_t[b["sink"]]) == 7.25
    assert np.unique(b["tgt"]).size < b["tgt"].size   # siblings share targets


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_block_trsv_plain_matches_reference(mode, pairs, dtype):
    k, wb, rb = 4, 8, 8
    P, Q, w, r, bkm = panel_bucket(k, wb, rb, dtype, 7, pairs)
    Pf, _, _ = _ref_panel(P, Q, w, r, 0.5, bkm, pairs, True)
    D = np.asarray(Pf)[:, :wb, :].copy()
    D[-1] = 9.0                                    # garbage in the pad lane
    y = np.random.default_rng(8).normal(size=(k, wb)).astype(dtype)
    xr = rsn.block_trsv(jnp.asarray(D), jnp.asarray(y), jnp.asarray(w),
                        jnp.asarray(bkm), mode=mode, pairs=pairs,
                        interpret=True)
    xt = tsn.block_trsv(torch.tensor(D), torch.tensor(y), torch.tensor(w),
                        torch.tensor(bkm), mode=mode, pairs=pairs)
    assert rel(xt, xr) <= TOL[dtype]
    # m right-hand sides at once == one solve per column
    Y = np.random.default_rng(9).normal(size=(k, wb, 3)).astype(dtype)
    X = tsn.block_trsv(torch.tensor(D), torch.tensor(Y), torch.tensor(w),
                       torch.tensor(bkm), mode=mode, pairs=pairs)
    for j in range(3):
        xj = tref.sn_trsv_ref(torch.tensor(D), torch.tensor(Y[:, :, j]),
                              torch.tensor(w), torch.tensor(bkm), mode=mode,
                              pairs=pairs)
        np.testing.assert_array_equal(np_of(X[:, :, j]), np_of(xj))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_sweep_plain_matches_reference(mode, pairs, dtype):
    """One bucket of a sweep, in place in y: the port's plain version
    against the reference's per-bucket step ``_sn_sweep_fn`` on the same
    factors, tables and y — its jnp oracle and its Pallas ``block_trsv`` in
    interpret mode — with ragged lanes, an all-pad lane and sibling lanes
    that share sub-rows.  The scratch row holds the reference's zero."""
    C, y, tb = sweep_bucket(5, 8, 16, dtype, 31, pairs)
    n = y.shape[0] - 1
    y[n] = 0.0
    bk = sweep_bucket_on(tb, "cpu")
    got = tref.sn_sweep_inplace_ref(
        torch.tensor(C), torch.tensor(y), bk.pidx, bk.qidx, bk.rows,
        bk.wvec, bk.rvec, bk.bkm, mode=mode, pairs=pairs)
    assert np.array_equal(np_of(tsn.sn_sweep_inplace(
        torch.tensor(C), torch.tensor(y), bk, mode)), np_of(got))
    args = [jnp.asarray(a) for a in (C, y[:, 0], tb["pidx"], tb["qidx"],
                                     tb["rows"], tb["w"], tb["r"], tb["bkm"])]
    for use_pallas in (False, True):
        want = _sn_sweep_fn(8, 16, pairs, mode, use_pallas)(*args)
        assert rel(got[:, 0], want) <= TOL[dtype]
