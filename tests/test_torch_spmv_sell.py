"""The sliced-ELL layout of the block-ELL SpMV (``core.sparse.build_sell``)
and its plain version against the JAX reference: the reference's
``bell_spmv_pallas`` in interpret mode, the port's product on the old dense
tiles and the COO product, on 2-D Poisson, a non-square random pattern,
empty rows and columns, and a slice with one long row; the gradients against
the reference's ``jax.grad``; and the ``backend="pallas"`` solve on the CPU,
which builds no dense tiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import build_bell as r_build_bell
from repro.data import poisson as rpoisson
from repro.kernels import ops as rops
from repro.kernels.spmv_bell import bell_spmv_pallas
from repro_torch.core.sparse import (SELL_SLICE, bell_to_device, build_bell,
                                     build_sell, coo_matvec)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_close, tol

CASES = ("poisson", "nonsquare", "empty", "long_row")


def _pattern(case, seed=0):
    """(row, col, (n, m)) of one test pattern, made with numpy."""
    rng = np.random.default_rng(seed)
    if case == "poisson":
        A = rpoisson.poisson2d(13)
        return np.asarray(A.row), np.asarray(A.col), A.shape
    if case == "nonsquare":
        n, m, nnz = 150, 333, 1800
    elif case == "empty":
        n, m, nnz = 200, 170, 900
    else:
        n, m, nnz = 97, 260, 500
    keys = np.unique(rng.integers(0, n * m, nnz))
    row, col = keys // m, keys % m
    if case == "empty":
        # rows 40..99 and columns 0..29, 100..139 hold nothing
        keep = ~(((row >= 40) & (row < 100)) | (col < 30)
                 | ((col >= 100) & (col < 140)))
        row, col = row[keep], col[keep]
    if case == "long_row":
        # row 37 is full: its slice is padded to m entries per row
        full = np.arange(m)
        keys = np.unique(np.concatenate([row * m + col, 37 * m + full]))
        row, col = keys // m, keys % m
    return row.astype(np.int32), col.astype(np.int32), (n, m)


def _inputs(case, dtype, seed=0):
    row, col, (n, m) = _pattern(case, seed)
    rng = np.random.default_rng(seed + 1)
    val = rng.normal(size=len(row)).astype(dtype)
    x = rng.normal(size=m).astype(dtype)
    return row, col, (n, m), val, x


@pytest.mark.parametrize("case,max_k", [(c, None) for c in CASES]
                         + [("nonsquare", 2), ("long_row", 1)])
def test_sell_layout_holds_each_kept_entry_once(case, max_k):
    row, col, shape, val, _ = _inputs(case, np.float64)
    meta, bcols, perm = build_bell(row, col, shape, max_k=max_k)
    sell = build_sell(meta, bcols, perm)
    keep = perm >= 0
    assert np.array_equal(sell.spos >= 0, keep)
    if max_k is not None:
        assert not keep.all()           # the cap really dropped entries
    slots = sell.spos[keep]
    assert len(np.unique(slots)) == len(slots)          # once each
    assert slots.min() >= 0 and slots.max() < sell.n_slots
    # each slot decodes to its entry's (row, col)
    width = np.diff(sell.slice_ptr) // SELL_SLICE
    slc = np.searchsorted(sell.slice_ptr, slots, side="right") - 1
    r = slc * SELL_SLICE + (slots - sell.slice_ptr[slc]) % SELL_SLICE
    assert np.array_equal(r, row[keep])
    # the column is the one the block-ELL plan holds: under a max_k cap the
    # reference's slot table keeps the last block written to slot k - 1
    p = perm[keep]
    blk = p // (meta.bm * meta.bn)
    want = bcols[blk // meta.k, blk % meta.k].astype(np.int64) * meta.bn \
        + p % meta.bn
    assert np.array_equal(sell.cols[slots], want)
    if max_k is None:
        assert np.array_equal(want, col)
    # each slice is padded to its longest row; the padding is zero
    lens = np.bincount(row[keep], minlength=len(width) * SELL_SLICE)
    assert np.array_equal(width, lens.reshape(-1, SELL_SLICE).max(axis=1))
    assert sell.n_slots == SELL_SLICE * width.sum()
    packed = tops.sell_assemble(sell.to("cpu"), torch.tensor(val))
    pad = np.ones(sell.n_slots, bool)
    pad[slots] = False
    assert (packed.numpy()[pad] == 0).all()
    assert (sell.cols[pad] == 0).all()
    assert_close(packed[torch.tensor(slots)], val[keep], rtol=0, atol=0)


@pytest.mark.parametrize("case,max_k", [(c, None) for c in CASES]
                         + [("nonsquare", 2), ("long_row", 1)])
def test_sell_entry_coords_match_the_block_ell_decode(case, max_k):
    """The backward's (keep, row, col), read from the sliced layout, equal
    the reference's decode of ``perm`` through the slot table; only the
    sliced layout lies on the device."""
    row, col, shape, _, _ = _inputs(case, np.float64)
    bell = bell_to_device(build_bell(row, col, shape, max_k=max_k), "cpu")
    assert isinstance(bell.block_cols, np.ndarray)
    assert isinstance(bell.perm, np.ndarray)
    keep, r, c = bell.sell.entry_coords()
    meta, p = bell.meta, bell.perm
    assert np.array_equal(keep.numpy(), p >= 0)
    k = p >= 0
    blk = p[k] // (meta.bm * meta.bn)
    want_r = (blk // meta.k) * meta.bm + (p[k] // meta.bn) % meta.bm
    want_c = bell.block_cols[blk // meta.k, blk % meta.k].astype(np.int64) \
        * meta.bn + p[k] % meta.bn
    assert np.array_equal(r.numpy()[k], want_r)
    assert np.array_equal(c.numpy()[k], want_c)
    assert (r.numpy()[~k] == 0).all() and (c.numpy()[~k] == 0).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sell_plain_matches_reference_and_old_tiles(case, dtype):
    row, col, (n, m), val, x = _inputs(case, dtype, seed=3)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    tiles_r = rops.bell_assemble(rmeta, rperm, jnp.asarray(val))
    y_r = bell_spmv_pallas(rmeta, jnp.asarray(rcols), tiles_r,
                           jnp.asarray(x), interpret=True)[:n]
    bell = bell_to_device(build_bell(row, col, (n, m)), "cpu")
    vt, xt = torch.tensor(val), torch.tensor(x)
    packed = tops.sell_assemble(bell.sell, vt)
    y = tref.sell_matvec_ref(bell.sell.slice_ptr, bell.sell.cols, packed,
                             xt, n)
    assert y.shape == (n,) and y.dtype == vt.dtype
    assert_close(y, y_r, **tol(dtype))
    assert_close(y, tops.bell_matvec_ref(bell, vt, xt, n), **tol(dtype))
    assert_close(y, coo_matvec(vt, torch.tensor(row).long(),
                               torch.tensor(col).long(), xt, n), **tol(dtype))
    # the differentiable wrapper runs the same plain version on the CPU
    assert_close(tops.bell_matvec(bell, vt, xt, n), y, rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_t_bell", [False, True])
def test_sell_gradients_match_reference(case, with_t_bell):
    row, col, (n, m), val, x = _inputs(case, np.float64, seed=5)
    w = np.random.default_rng(6).normal(size=n)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    gr = jax.grad(lambda vv, xx: jnp.sum(jnp.asarray(w) * rops.bell_matvec(
        rmeta, rcols, rperm, vv, xx, n)), (0, 1))(jnp.asarray(val),
                                                  jnp.asarray(x))
    bell = bell_to_device(build_bell(row, col, (n, m)), "cpu")
    t_bell = bell_to_device(build_bell(col, row, (m, n)), "cpu") \
        if with_t_bell else None
    vt = torch.tensor(val, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    (torch.tensor(w) * tops.bell_matvec(bell, vt, xt, n,
                                        t_bell=t_bell)).sum().backward()
    assert_close(vt.grad, gr[0], rtol=1e-10, atol=1e-12)
    assert_close(xt.grad, gr[1], rtol=1e-10, atol=1e-12)


def test_bell_to_device_reuses_a_built_layout():
    row, col, shape, _, _ = _inputs("nonsquare", np.float64)
    bell = bell_to_device(build_bell(row, col, shape), "cpu")
    again = bell_to_device(bell, "cpu")
    assert again.sell.n_slots == bell.sell.n_slots
    assert torch.equal(again.sell.cols, bell.sell.cols)
    assert torch.equal(again.sell.spos, bell.sell.spos)


@pytest.mark.parametrize("symmetric", [True, False])
def test_pallas_solve_builds_no_tiles_on_cpu(monkeypatch, symmetric):
    """The backend="pallas" solve and its gradient run through the sliced
    layout only: the dense-tile builders are never called, and the plan
    counters equal the reference's."""
    from test_torch_solve import _coo_ref, _sweep

    def no_tiles(*a, **k):
        raise AssertionError("a dense block-ELL tile tensor was built")

    monkeypatch.setattr(tops, "bell_assemble", no_tiles)
    monkeypatch.setattr(tref, "bell_matvec_ref", no_tiles)
    method = "cg" if symmetric else "bicgstab"
    stats_r, stats_t, g_r, g_t = _sweep(_coo_ref(9, symmetric), "pallas",
                                        method, "off")
    assert stats_t == stats_r
    for a, b in zip(g_t, g_r):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_lane_chunks_split_every_batch_into_kernel_chunks():
    """The lane kernel's launch plan: chunk sizes it is built for, largest
    first, covering B exactly (8s, then the binary digits of the rest)."""
    from repro_torch.kernels.spmv_bell import LANE_CHUNKS, lane_chunks
    assert lane_chunks(0) == []
    assert lane_chunks(8) == [(8, 1)]
    assert lane_chunks(20) == [(8, 2), (4, 1)]
    assert lane_chunks(33) == [(8, 4), (1, 1)]
    assert lane_chunks(15) == [(8, 1), (4, 1), (2, 1), (1, 1)]
    for B in range(1, 100):
        plan = lane_chunks(B)
        sizes = [c for c, _ in plan]
        assert set(sizes) <= set(LANE_CHUNKS)
        assert sizes == sorted(set(sizes), reverse=True)
        assert sum(c * k for c, k in plan) == B
        assert all(k == 1 for c, k in plan if c < 8)
