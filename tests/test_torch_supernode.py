"""PyTorch port vs the JAX reference: the supernodal panel kernels.

Each plain version (``repro_torch.kernels.ref``: ``sn_panel_factor_ref``,
``sn_schur_ref``, ``sn_trsv_ref``, ``sn_pair_det``, and the in-place forms
``sn_panel_factor_inplace_ref`` / ``sn_schur_inplace_ref`` that read and
write a factor vector through slot tables) against the reference's Pallas
kernel run with ``interpret=True`` on the same numpy inputs — ragged lanes
(w < wb, r < rb), an all-pad lane, NaN-free garbage in every pad slot,
static 2x2 pivot pairs, and sibling lanes whose extend-add targets
overlap.  Errors are measured against the output's scale (max |reference|;
for the GEMM the product of |inputs|): 1e-12 in f64, 1e-5 in f32.  On a
CUDA card, each hand-written kernel against its plain version at the same
tolerances (skipped here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels import supernode as rsn
from repro_torch.kernels import ref as tref
from repro_torch.kernels import supernode as tsn

from _torch_parity import cuda_device, np_of  # noqa: F401

TOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(3, 8, 16), (5, 4, 8), (4, 2, 4), (2, 8, 32)]   # (k, wb, rb)
MODES = ("l", "lt", "u", "ut")


def _rel(got, want, scale=None):
    """max |got − want| over max |scale| (default: |want|)."""
    got, want = np_of(got).astype(np.float64), np_of(want).astype(np.float64)
    sc = np.abs(want if scale is None else np_of(scale)).max()
    return float(np.abs(got - want).max() / max(sc, 1e-300))


def _bucket(k, wb, rb, dtype, seed, pairs):
    """A gathered bucket: garbage everywhere, a diagonally dominant true
    block, ragged true sizes, the last lane all-pad (w = r = 0)."""
    rng = np.random.default_rng(seed)
    P = (3.0 * rng.normal(size=(k, wb + rb, wb))).astype(dtype)
    Q = (3.0 * rng.normal(size=(k, wb, rb))).astype(dtype)
    w = rng.integers(1, wb + 1, k).astype(np.int32)
    r = rng.integers(0, rb + 1, k).astype(np.int32)
    w[0], r[0] = wb, rb
    w[-1], r[-1] = 0, 0
    aw = np.arange(wb)
    bkm = np.zeros((k, wb), bool)
    for lane in range(k):
        P[lane, aw, aw] += 4.0 * wb
        if pairs:
            bkm[lane] = (aw % 2 == 0) & (aw + 1 < w[lane])
            starts = aw[bkm[lane]]
            P[lane, starts, starts] = 0.0          # indefinite: a zero pivot
            P[lane, starts, starts + 1] = 4.0 * wb  # ... in a sound 2x2 block
            P[lane, starts + 1, starts] = 4.0 * wb
    return P, Q, w, r, bkm


def _inplace_bucket(k, wb, rb, dtype, seed, pairs):
    """A bucket addressed into a factor vector C: live panel entries on
    distinct shuffled slots, every pad entry on one sink slot holding
    garbage (7.25), and per lane r × r extend-add targets drawn from one
    shared pool, so sibling lanes share some targets."""
    P, Q, w, r, bkm = _bucket(k, wb, rb, dtype, seed, pairs)
    rng = np.random.default_rng(seed + 100)
    pm, qm = (np_of(m) for m in tref.sn_live_masks(
        torch.tensor(w), torch.tensor(r), wb, rb, "cpu"))
    n_p, n_live = int(pm.sum()), int(pm.sum() + qm.sum())
    pool = int((r.astype(np.int64) ** 2).max()) + 3
    sink = n_live + pool
    slots = rng.permutation(n_live).astype(np.int32)
    pidx = np.full(P.shape, sink, np.int32)
    qidx = np.full(Q.shape, sink, np.int32)
    pidx[pm], qidx[qm] = slots[:n_p], slots[n_p:]
    C = (3.0 * rng.normal(size=sink + 2)).astype(dtype)
    C[pidx[pm]], C[qidx[qm]] = P[pm], Q[qm]
    C[sink] = 7.25
    tgt = np.concatenate([n_live + rng.choice(pool, int(rl) ** 2,
                                              replace=False) for rl in r])
    toff = np.concatenate([[0], np.cumsum(r.astype(np.int64) ** 2)])
    return dict(C=C, pidx=pidx, qidx=qidx, w=w, r=r, bkm=bkm,
                tgt=tgt.astype(np.int32), toff=toff, sink=sink, pm=pm, qm=qm)


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


def _port_inplace(b, tau, pairs, device="cpu", guard=True):
    """The port's in-place wrappers on a copy of C: (C after panel_factor,
    nbad, C after schur_update)."""
    t = lambda a: torch.tensor(a, device=device)
    C = t(b["C"])
    args = (t(b["pidx"]), t(b["qidx"]), t(b["w"]), t(b["r"]))
    nb = tsn.panel_factor_inplace(C, *args, tau, t(b["bkm"]), pairs=pairs,
                                  guard=guard)
    Cf = C.clone()
    tsn.schur_update_inplace(C, *args, t(b["tgt"]), t(b["toff"]))
    return Cf, float(nb), C


def _ref_panel(P, Q, w, r, tau, bkm, pairs, guard):
    return rsn.panel_factor(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w),
                            jnp.asarray(r), tau, jnp.asarray(bkm),
                            pairs=pairs, guard=guard, interpret=True)


def _port_panel(P, Q, w, r, tau, bkm, pairs, guard):
    t = torch.tensor
    return tref.sn_panel_factor_ref(t(P), t(Q), t(w), t(r), tau, t(bkm),
                                    pairs=pairs, guard=guard)


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
    P, Q, w, r, bkm = _bucket(k, wb, rb, dtype, 11 + wb, pairs)
    tau = 0.5
    Pr, Qr, nr = _ref_panel(P, Q, w, r, tau, bkm, pairs, True)
    Pt, Qt, nt = _port_panel(P, Q, w, r, tau, bkm, pairs, True)
    assert _rel(Pt, Pr) <= TOL[dtype]
    assert _rel(Qt, Qr) <= TOL[dtype]
    assert float(nt) == float(nr)
    if pairs:
        assert float(nt) == 0.0                    # pairs cover the zeros


def test_panel_factor_guard_off_and_clamp_count_match_reference():
    P, Q, w, r, bkm = _bucket(4, 8, 8, np.float64, 3, False)
    P[0, 0, 0] = 1e-14                             # a clamped 1x1 pivot
    for guard in (True, False):
        Pr, Qr, nr = _ref_panel(P, Q, w, r, 1e-6, bkm, False, guard)
        Pt, Qt, nt = _port_panel(P, Q, w, r, 1e-6, bkm, False, guard)
        assert float(nt) == float(nr) == (1.0 if guard else 0.0)
        assert _rel(Pt, Pr) <= 1e-12 and _rel(Qt, Qr) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_schur_plain_matches_reference(shape, dtype):
    k, wb, rb = shape
    P, Q, w, r, bkm = _bucket(k, wb, rb, dtype, 5, False)
    Sr = rsn.schur_update(jnp.asarray(P), jnp.asarray(Q), interpret=True)
    St = tref.sn_schur_ref(torch.tensor(P), torch.tensor(Q))
    scale = tref.sn_schur_ref(torch.tensor(np.abs(P)), torch.tensor(np.abs(Q)))
    assert St.shape == (k, rb, rb)
    assert _rel(St, Sr, scale) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("shape", [(5, 4, 8), (3, 8, 16), (7, 3, 5)])
def test_inplace_plain_matches_reference(shape, pairs, dtype):
    """panel_factor and the fused schur_update in place in C, through slot
    tables whose pads all name one sink slot: every slot of C as the
    reference leaves it (gather, Pallas kernel, scatter, C[tgt] -= S), the
    same clamp count, and the sink never written."""
    k, wb, rb = shape
    b = _inplace_bucket(k, wb, rb, dtype, 21 + wb, pairs)
    Cf_r, nr, Cs_r = _ref_inplace(b, 0.5, pairs)
    Cf_t, nt, Cs_t = _port_inplace(b, 0.5, pairs)
    assert _rel(Cf_t, Cf_r) <= TOL[dtype]
    assert _rel(Cs_t, Cs_r) <= TOL[dtype]
    assert nt == nr
    assert float(Cs_t[b["sink"]]) == 7.25
    assert np.unique(b["tgt"]).size < b["tgt"].size   # siblings share targets


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_block_trsv_plain_matches_reference(mode, pairs, dtype):
    k, wb, rb = 4, 8, 8
    P, Q, w, r, bkm = _bucket(k, wb, rb, dtype, 7, pairs)
    Pf, _, _ = _ref_panel(P, Q, w, r, 0.5, bkm, pairs, True)
    D = np.asarray(Pf)[:, :wb, :].copy()
    D[-1] = 9.0                                    # garbage in the pad lane
    y = np.random.default_rng(8).normal(size=(k, wb)).astype(dtype)
    xr = rsn.block_trsv(jnp.asarray(D), jnp.asarray(y), jnp.asarray(w),
                        jnp.asarray(bkm), mode=mode, pairs=pairs,
                        interpret=True)
    xt = tsn.block_trsv(torch.tensor(D), torch.tensor(y), torch.tensor(w),
                        torch.tensor(bkm), mode=mode, pairs=pairs)
    assert _rel(xt, xr) <= TOL[dtype]
    # m right-hand sides at once == one solve per column
    Y = np.random.default_rng(9).normal(size=(k, wb, 3)).astype(dtype)
    X = tsn.block_trsv(torch.tensor(D), torch.tensor(Y), torch.tensor(w),
                       torch.tensor(bkm), mode=mode, pairs=pairs)
    for j in range(3):
        xj = tref.sn_trsv_ref(torch.tensor(D), torch.tensor(Y[:, :, j]),
                              torch.tensor(w), torch.tensor(bkm), mode=mode,
                              pairs=pairs)
        np.testing.assert_array_equal(np_of(X[:, :, j]), np_of(xj))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_panel_factor_and_schur_match_plain(cuda_device, pairs, dtype):
    """Both kernels in place on ragged buckets (garbage in the pad slots,
    sibling lanes sharing targets; (3, 32, 1024) splits each lane over 16
    blocks) against the plain in-place versions."""
    for shape in SHAPES + [(3, 32, 1024), (7, 3, 5)]:
        k, wb, rb = shape
        b = _inplace_bucket(k, wb, rb, dtype, 3, pairs)
        Cf_k, nbk, Cs_k = _port_inplace(b, 0.5, pairs, cuda_device)
        torch.cuda.synchronize()
        Cf_p, nbp, Cs_p = _port_inplace(b, 0.5, pairs)
        assert _rel(Cf_k, Cf_p) <= TOL[dtype] and nbk == nbp
        assert _rel(Cs_k, Cs_p) <= TOL[dtype]
        assert float(Cf_k[b["sink"]]) == float(Cs_k[b["sink"]]) == 7.25


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_split_lanes_repeat_with_one_work_vector(cuda_device, pairs):
    """Lanes split over several blocks ((3, 32, 1024): 16 blocks a lane;
    (2, 32, 100): 2), factored again and again with one ``work`` vector: the
    plain version's C and clamp count every time, the counters back at 0."""
    work = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for shape in [(3, 32, 1024), (2, 32, 100)]:
        b = _inplace_bucket(*shape, np.float64, 4, pairs)
        Cf_p, nbp, _ = _port_inplace(b, 0.5, pairs)
        t = lambda a: torch.tensor(a, device=cuda_device)
        args = (t(b["pidx"]), t(b["qidx"]), t(b["w"]), t(b["r"]), 0.5,
                t(b["bkm"]))
        for _ in range(8):
            C = t(b["C"])
            nb = tsn.panel_factor_inplace(C, *args, pairs=pairs, work=work)
            torch.cuda.synchronize()
            assert _rel(C, Cf_p) <= TOL[np.float64] and float(nb) == nbp
            assert int(work.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_block_trsv_matches_plain(cuda_device, mode, pairs):
    for dtype in (np.float64, np.float32):
        k, wb, rb = 5, 32, 64
        P, Q, w, r, bkm = _bucket(k, wb, rb, dtype, 2, pairs)
        Pf = _port_panel(P, Q, w, r, 0.5, bkm, pairs, True)[0].to(cuda_device)
        wt = torch.tensor(w, device=cuda_device)
        bt = torch.tensor(bkm, device=cuda_device)
        for m in (1, 5):
            y = torch.tensor(np.random.default_rng(m).normal(
                size=(k, wb, m)).astype(dtype), device=cuda_device)
            D = Pf[:, :wb, :]                      # strided view: no copy
            x = tsn.block_trsv(D, y, wt, bt, mode=mode, pairs=pairs)
            torch.cuda.synchronize()
            want = tref.sn_trsv_ref(D, y, wt, bt, mode=mode, pairs=pairs)
            assert _rel(x, want) <= TOL[dtype]
