"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; a
reference tensor crosses to the port as numpy arrays through
``repro_torch.core.convert`` (the port itself never imports the reference).
Nothing here imports the reference: ``test_torch_on_card.py`` uses these
helpers on a card machine that has no jax.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.convert import sparse_from_arrays
from repro_torch.core.direct import SnodeBucket
from repro_torch.kernels import ref as tref
from repro_torch.kernels import supernode as tsn

CPU = "cpu"


def tol(dtype):
    """Kernel parity tolerances (the reference's test_kernels ``_tol``)."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else
            dict(rtol=1e-12, atol=1e-12))


def port_of(A_ref, device=CPU):
    """The port's SparseTensor for a reference SparseTensor."""
    d = {"val": np.asarray(A_ref.val), "row": np.asarray(A_ref.row),
         "col": np.asarray(A_ref.col), "shape": A_ref.shape,
         "props": dict(A_ref.props)}
    if A_ref.stencil is not None:
        d["stencil"] = (A_ref.stencil.nx, A_ref.stencil.ny)
    return sparse_from_arrays(d, device=device)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, **kw):
    np.testing.assert_allclose(np_of(a), np_of(b), **kw)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels have no CPU build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels only run on the "
                    "card (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def rel(got, want, scale=None):
    """max |got − want| over max |scale| (default: |want|)."""
    got, want = np_of(got).astype(np.float64), np_of(want).astype(np.float64)
    sc = np.abs(want if scale is None else np_of(scale)).max()
    return float(np.abs(got - want).max() / max(sc, 1e-300))


def panel_bucket(k, wb, rb, dtype, seed, pairs):
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


def inplace_bucket(k, wb, rb, dtype, seed, pairs):
    """A bucket addressed into a factor vector C: live panel entries on
    distinct shuffled slots, every pad entry on one sink slot holding
    garbage (7.25), and per lane r × r extend-add targets drawn from one
    shared pool, so sibling lanes share some targets."""
    P, Q, w, r, bkm = panel_bucket(k, wb, rb, dtype, seed, pairs)
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


def port_inplace(b, tau, pairs, device="cpu", guard=True):
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


def port_panel(P, Q, w, r, tau, bkm, pairs, guard):
    t = torch.tensor
    return tref.sn_panel_factor_ref(t(P), t(Q), t(w), t(r), tau, t(bkm),
                                    pairs=pairs, guard=guard)




# kernel name → (vector-argument count, scalar-argument count)
FUSED_SIGS = {
    "fused_cg_update": (5, 1),
    "fused_cg_direction": (4, 1),
    "fused_cg_halfstep": (4, 1),
    "fused_cheb_step": (3, 2),
    "fused_dots2": (2, 0),
    "fused_bicg_p": (4, 3),
    "fused_bicg_s": (3, 1),
    "fused_bicg_tail": (6, 2),
}


def stencil_case(nx, ny, dtype, seed):
    rng = np.random.default_rng(seed)
    val5 = rng.normal(size=(5, nx, ny)).astype(dtype)
    val5[1, 0, :] = 0; val5[2, -1, :] = 0
    val5[3, :, 0] = 0; val5[4, :, -1] = 0
    x = rng.normal(size=(nx * ny,)).astype(dtype)
    return val5.reshape(-1), x


def bell_case(n, m, density, dtype, seed):
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n * m * density))
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, m, nnz)
    keys = np.unique(row.astype(np.int64) * m + col)
    row = (keys // m).astype(np.int32)
    col = (keys % m).astype(np.int32)
    val = rng.normal(size=len(row)).astype(dtype)
    x = rng.normal(size=m).astype(dtype)
    return row, col, val, x


def fused_inputs(name, n, dtype, seed):
    n_vec, n_sc = FUSED_SIGS[name]
    rng = np.random.default_rng(seed)
    vecs = [rng.normal(size=n).astype(dtype) for _ in range(n_vec)]
    scalars = [dtype(rng.normal()) for _ in range(n_sc)]
    return vecs, scalars


def sweep_bucket(k, wb, rb, dtype, seed, pairs, m=1):
    """A factored bucket for one sweep step: the factor vector of
    :func:`inplace_bucket` after the plain ``panel_factor`` (pads on the
    sink, 7.25 there), lane l's block rows its own (l·wb + i), its sub-rows
    distinct rows of one shared pool of ancestor rows (neighbouring lanes
    share some), pads naming the scratch row n; y (n+1, m) random with 7.25
    in the scratch row and two rows that no lane names.  Returns
    (C, y, tables) as numpy, ``tables`` the bucket's fields."""
    b = inplace_bucket(k, wb, rb, dtype, seed, pairs)
    C = torch.tensor(b["C"])
    t = torch.tensor
    tsn.panel_factor_inplace(C, t(b["pidx"]), t(b["qidx"]), t(b["w"]),
                             t(b["r"]), 0.5, t(b["bkm"]), pairs=pairs)
    w, r = b["w"], b["r"]
    rng = np.random.default_rng(seed + 200)
    pool = rb + k
    n = k * wb + pool + 2
    aw = np.arange(wb)
    rows_b = np.where(aw[None, :] < w[:, None],
                      np.arange(k * wb).reshape(k, wb), n)
    # lane l takes r_l consecutive entries of one shuffled pool from entry
    # l on: distinct within a lane, shared with its neighbours
    order = k * wb + rng.permutation(pool)
    rows_s = np.full((k, rb), n)
    for lane in range(k):
        rows_s[lane, :r[lane]] = order[lane:lane + r[lane]]
    rows = np.concatenate([rows_b, rows_s], axis=1).astype(np.int32)
    y = rng.normal(size=(n + 1, m)).astype(dtype)
    y[n] = 7.25
    tables = dict(pidx=b["pidx"], qidx=b["qidx"], tgt=b["tgt"], rows=rows,
                  w=w, r=r, bkm=b["bkm"], wb=wb, rb=rb, pairs=pairs)
    return np_of(C), y, tables


def sweep_bucket_on(tb, device):
    """The tables of :func:`sweep_bucket` as a ``SnodeBucket`` on
    ``device``, in the dtypes ``direct.to_device`` places."""
    def t(a, dtype=torch.int32):
        return torch.tensor(a, dtype=dtype, device=device)
    bk = SnodeBucket(wb=tb["wb"], rb=tb["rb"], pairs=tb["pairs"],
                     pidx=t(tb["pidx"]), qidx=t(tb["qidx"]),
                     uidx=t(tb["tgt"]), rows=t(tb["rows"]), wvec=t(tb["w"]),
                     rvec=t(tb["r"]), bkm=t(tb["bkm"], torch.bool))
    tsn.check_sweep_bucket(bk, device)
    return bk
