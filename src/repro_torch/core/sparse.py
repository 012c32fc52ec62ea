"""Typed sparse tensors (PyTorch port of ``repro.core.sparse``).

``SparseTensor`` — one matrix in COO form ``(val, row, col)``.  Auxiliary
kernel layouts (block-ELL with its sliced-ELL form for the SpMV kernel,
5-point stencil metadata) are attached at construction time when asked for.
The numpy symbolic helpers
(:func:`build_bell`, :func:`detect_properties`, :func:`has_full_diagonal`,
and the algebraic-multigrid pattern passes :func:`aggregate_pattern`,
:func:`spgemm_program`, :func:`tentative_coarse_pattern`) are kept as copies
of the reference's so analyze artifacts compare array for array.  Leading batch dimensions on ``val`` are accepted by the COO products;
batched *solves* come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device, to_numpy

__all__ = [
    "SparseTensor",
    "BellMeta",
    "coo_matvec",
    "coo_rmatvec",
    "coo_to_dense",
    "coo_diagonal",
    "detect_properties",
    "has_full_diagonal",
    "build_bell",
    "build_sell",
    "BellLayout",
    "SellLayout",
    "aggregate_pattern",
    "spgemm_program",
    "tentative_coarse_pattern",
]


def has_full_diagonal(row, col, n: int) -> bool:
    """True when every diagonal position is structurally present."""
    r = to_numpy(row)
    c = to_numpy(col)
    return bool(np.unique(r[r == c]).size == n)


# ---------------------------------------------------------------------------
# COO products (plain torch: the reference computes these outside any kernel)
# ---------------------------------------------------------------------------

def coo_matvec(val: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
               x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y = A @ x for COO A, as one ``index_add_`` segment sum.  Leading batch
    dims on ``val``/``x`` broadcast.  On CUDA ``index_add_`` accumulates with
    atomics, so the summation order (and the last bits) can vary per run."""
    prod = val * x[..., col]
    y = torch.zeros(prod.shape[:-1] + (n_rows,), dtype=prod.dtype,
                    device=prod.device)
    return y.index_add_(-1, row, prod)


def coo_rmatvec(val, row, col, y, n_cols):
    """x = Aᵀ @ y — transpose is a row/col swap."""
    return coo_matvec(val, col, row, y, n_cols)


def coo_to_dense(val, row, col, shape):
    n, m = shape
    out = torch.zeros(val.shape[:-1] + (n * m,), dtype=val.dtype,
                      device=val.device)
    return out.index_add_(-1, row * m + col, val).reshape(
        val.shape[:-1] + (n, m))


def coo_diagonal(val, row, col, n):
    mask = row == col
    d = torch.zeros(val.shape[:-1] + (n,), dtype=val.dtype, device=val.device)
    return d.index_add_(-1, row, torch.where(mask, val, torch.zeros_like(val)))


# ---------------------------------------------------------------------------
# pattern analysis (numpy — runs once at construction)
# ---------------------------------------------------------------------------

def detect_properties(val, row, col, shape, check_values: bool = True) -> dict:
    """Detect structural symmetry / SPD-likelihood (copy of the reference)."""
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    if shape[0] != shape[1]:
        return props
    r = to_numpy(row)
    c = to_numpy(col)
    props["sorted_rows"] = bool(np.all(np.diff(r) >= 0))
    props["struct_full_diag"] = has_full_diagonal(r, c, shape[0])
    key_f = (r.astype(np.int64) * shape[1] + c)
    key_t = (c.astype(np.int64) * shape[1] + r)
    of, ot = np.argsort(key_f), np.argsort(key_t)
    if not np.array_equal(key_f[of], key_t[ot]):
        return props  # pattern not symmetric
    sym = True
    if check_values and val is not None:
        v = to_numpy(val)
        vf = v[..., of]
        vt = v[..., ot]
        sym = bool(np.allclose(vf, vt, rtol=1e-12, atol=1e-12))
        if sym:
            # cheap SPD hint: all diagonal entries present and positive
            dmask = r == c
            diag = np.zeros(v.shape[:-1] + (shape[0],), v.dtype)
            flat = diag.reshape(-1, shape[0])
            vflat = v.reshape(-1, v.shape[-1])
            for b in range(flat.shape[0]):
                np.add.at(flat[b], r[dmask], vflat[b][dmask])
            props["spd_hint"] = bool(np.all(flat > 0))
    props["symmetric"] = sym
    return props


# ---------------------------------------------------------------------------
# pattern-level coarsening / product helpers (numpy copies: the symbolic
# half of the algebraic-multigrid plan, see core/multigrid.py)
# ---------------------------------------------------------------------------

def aggregate_pattern(row, col, n: int):
    """Greedy aggregation of the (symmetrized) pattern graph.

    Pass 1 seeds an aggregate at every node whose whole neighbourhood is
    still free (node ∪ neighbours become one aggregate — Vaněk's sweep);
    pass 2 attaches leftover nodes to the neighbouring aggregate they touch
    most; pass 3 turns isolated stragglers into singletons.  The visiting
    order of the three passes decides the aggregates, so they are the
    reference's loops as they are.  Returns ``(agg, n_agg)``."""
    r = np.asarray(to_numpy(row), dtype=np.int64)
    c = np.asarray(to_numpy(col), dtype=np.int64)
    mask = r != c
    rr = np.concatenate([r[mask], c[mask]])
    cc = np.concatenate([c[mask], r[mask]])
    order = np.lexsort((cc, rr))
    rr, cc = rr[order], cc[order]
    keep = np.ones(len(rr), bool)
    keep[1:] = (rr[1:] != rr[:-1]) | (cc[1:] != cc[:-1])
    rr, cc = rr[keep], cc[keep]
    ptr = np.searchsorted(rr, np.arange(n + 1))

    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):                     # pass 1: free-neighbourhood seeds
        if agg[i] >= 0:
            continue
        nb = cc[ptr[i]:ptr[i + 1]]
        if nb.size and (agg[nb] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nb] = n_agg
        n_agg += 1
    for i in range(n):                     # pass 2: attach to busiest neighbour
        if agg[i] >= 0:
            continue
        nb_agg = agg[cc[ptr[i]:ptr[i + 1]]]
        nb_agg = nb_agg[nb_agg >= 0]
        if nb_agg.size:
            agg[i] = np.bincount(nb_agg).argmax()
    for i in range(n):                     # pass 3: isolated singletons
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, int(n_agg)


def spgemm_program(arow, acol, brow, bcol, shape_c):
    """Static index program for the sparse product C = A·B (pattern-level).

    Enumerates every structurally-nonzero pair (entry ``e`` of A, entry
    ``f`` of B with ``brow[f] == acol[e]``) and returns ``(ga, gb, gdst,
    crow, ccol)``: the numeric product is one gather + segment sum,
    ``c_val[gdst] += a_val[ga] * b_val[gb]``."""
    arow = np.asarray(arow, np.int64); acol = np.asarray(acol, np.int64)
    brow = np.asarray(brow, np.int64); bcol = np.asarray(bcol, np.int64)
    ob = np.argsort(brow, kind="stable")
    n_mid = int(max(acol.max(initial=-1), brow.max(initial=-1))) + 1
    bptr = np.searchsorted(brow[ob], np.arange(n_mid + 1))
    cnt = (bptr[acol + 1] - bptr[acol])            # pairs per A entry
    total = int(cnt.sum())
    ga = np.repeat(np.arange(len(arow), dtype=np.int64), cnt)
    grp = np.repeat(np.cumsum(cnt) - cnt, cnt)
    loc = np.arange(total, dtype=np.int64) - grp
    gb = ob[np.repeat(bptr[acol], cnt) + loc]
    keys = arow[ga] * np.int64(shape_c[1]) + bcol[gb]
    ukeys, gdst = np.unique(keys, return_inverse=True)
    crow = (ukeys // shape_c[1]).astype(np.int64)
    ccol = (ukeys % shape_c[1]).astype(np.int64)
    return ga, gb, gdst.reshape(-1).astype(np.int64), crow, ccol


def tentative_coarse_pattern(row, col, n: int, *, coarsest: int = 48,
                             max_levels: int = 12):
    """Repeated pattern aggregation down to ``coarsest`` nodes (values-free):
    ONE composed fine→coarse map and the coarse Galerkin pattern Tᵀ·A·T of
    the piecewise-constant prolongator, whose numeric matrix is one segment
    sum of the fine values through ``e2c``.  Returns ``(agg, n_c, e2c,
    crow, ccol)`` (the coarse level of the two-level Schwarz
    preconditioner)."""
    agg = np.arange(n, dtype=np.int64)
    n_c = n
    r = np.asarray(to_numpy(row), np.int64)
    c = np.asarray(to_numpy(col), np.int64)
    r0, c0 = r, c
    for _ in range(max_levels):
        if n_c <= coarsest:
            break
        a, na = aggregate_pattern(r, c, n_c)
        if na >= n_c:                       # aggregation stalled
            break
        agg = a[agg]
        keys = np.unique(a[r] * np.int64(na) + a[c])
        r = (keys // na).astype(np.int64)
        c = (keys % na).astype(np.int64)
        n_c = na
    keys = agg[r0] * np.int64(n_c) + agg[c0]
    ukeys, e2c = np.unique(keys, return_inverse=True)
    crow = (ukeys // n_c).astype(np.int64)
    ccol = (ukeys % n_c).astype(np.int64)
    return agg, int(n_c), e2c.reshape(-1).astype(np.int64), crow, ccol


# ---------------------------------------------------------------------------
# block-ELL construction for the BELL SpMV kernel (numpy copy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BellMeta:
    """Static layout of a block-ELL matrix (see kernels/spmv_bell.py)."""
    bm: int            # rows per row-band
    bn: int            # cols per column block
    n_rb: int          # number of row bands
    n_cb: int          # number of column blocks
    k: int             # blocks per row band (padded)
    n_pad: int         # padded row count
    m_pad: int         # padded col count
    fill: float        # nnz / (n_rb*k*bm*bn) — padding efficiency


def build_bell(row, col, shape, bm: int = 8, bn: int = 128,
               max_k: Optional[int] = None):
    """Block-ELLPACK layout: per row band, the list of non-empty column
    blocks (padded to k) plus a scatter map from COO nnz → dense block slots.

    Returns numpy ``(meta, block_cols[int32 (n_rb,k)], perm[int64 (nnz,)])``
    where ``perm[e]`` is the flat index into the (n_rb,k,bm,bn) value tensor
    for COO entry e (``-1`` for entries dropped by ``max_k``) — the same
    arrays as the reference's ``build_bell``.
    """
    r = to_numpy(row).astype(np.int64)
    c = to_numpy(col).astype(np.int64)
    n, m = shape
    n_rb = -(-n // bm)
    n_cb = -(-m // bn)
    rb = r // bm
    cb = c // bn
    key = rb * n_cb + cb
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    u_rb = uniq // n_cb
    u_cb = uniq % n_cb
    counts = np.bincount(u_rb, minlength=n_rb)
    k = int(counts.max()) if counts.size else 1
    if max_k is not None:
        k = min(k, max_k)
    # slot index of each unique block within its row band: a running count
    # per band (the reference's per-band arange, vectorized)
    order = np.argsort(u_rb, kind="stable")
    slot = np.zeros_like(u_rb)
    starts = np.cumsum(counts) - counts
    slot[order] = np.arange(len(u_rb), dtype=np.int64) - np.repeat(starts,
                                                                   counts)
    block_cols = np.zeros((n_rb, k), np.int32)
    block_cols[u_rb, np.minimum(slot, k - 1)] = u_cb.astype(np.int32)
    e_slot = slot[inv]
    keep = e_slot < k
    perm = ((rb * k + e_slot) * bm + r % bm) * bn + c % bn
    perm = np.where(keep, perm, -1).astype(np.int64)
    fill = float(len(r)) / float(max(n_rb * k * bm * bn, 1))
    meta = BellMeta(bm=bm, bn=bn, n_rb=int(n_rb), n_cb=int(n_cb), k=int(k),
                    n_pad=int(n_rb * bm), m_pad=int(n_cb * bn), fill=fill)
    return meta, block_cols, perm


#: rows per slice of the sliced-ELL layout (one warp, one lane per row)
SELL_SLICE = 32


@dataclasses.dataclass
class SellLayout:
    """Sliced-ELL layout of the matrix a block-ELL plan describes — the
    layout the CUDA SpMV kernel reads (see kernels/spmv_bell.py).

    Rows are cut into slices of :data:`SELL_SLICE`; a slice is padded to its
    longest row, and entry j of row r sits at slot
    ``slice_ptr[r // 32] + 32·j + r % 32`` (a warp's loads are coalesced).
    ``cols`` holds each slot's int32 column (0 in padding slots, whose value
    is 0); ``spos[e]`` is the slot of COO entry e (−1 for entries the
    block-ELL plan dropped), the counterpart of the block-ELL ``perm``."""
    n_rows: int                # rows covered (the block-ELL n_pad)
    n_slots: int               # padded entries, 32 · Σ slice widths
    slice_ptr: Any             # int64 (n_slices + 1,): first slot of a slice
    cols: Any                  # int32 (n_slots,)
    spos: Any                  # int64 (nnz,): COO entry → slot, −1 dropped

    def to(self, device) -> "SellLayout":
        def t(a, dt):
            return torch.as_tensor(to_numpy(a), dtype=dt, device=device)
        return SellLayout(self.n_rows, self.n_slots,
                          t(self.slice_ptr, torch.int64),
                          t(self.cols, torch.int32), t(self.spos, torch.int64))

    def entry_coords(self):
        """(keep, row, col) of every COO entry, decoded from its slot: the
        slice through ``slice_ptr``, the row from the slot's lane, the
        column from ``cols``.  Dropped entries read row 0, column 0."""
        keep = self.spos >= 0
        slot = torch.where(keep, self.spos, torch.zeros_like(self.spos))
        if self.n_slots == 0:
            zero = torch.zeros_like(slot)
            return keep, zero, zero
        s = torch.searchsorted(self.slice_ptr, slot, right=True) - 1
        row = s * SELL_SLICE + (slot - self.slice_ptr[s]) % SELL_SLICE
        zero = torch.zeros_like(row)
        col = self.cols[slot].long()
        return keep, torch.where(keep, row, zero), torch.where(keep, col, zero)


def build_sell(meta: BellMeta, block_cols, perm) -> SellLayout:
    """Sliced-ELL layout (numpy) of the matrix that the block-ELL slot table
    and scatter map describe: each kept COO entry is decoded from its
    block-ELL slot and stored once, in COO order within its row."""
    bc = to_numpy(block_cols).astype(np.int64)
    p = to_numpy(perm).astype(np.int64)
    keep = np.flatnonzero(p >= 0)
    t = p[keep]
    lc = t % meta.bn
    t = t // meta.bn
    lr = t % meta.bm
    t = t // meta.bm
    row = (t // meta.k) * meta.bm + lr
    col = bc.reshape(-1)[t] * meta.bn + lc
    n_rows = meta.n_pad
    n_slices = -(-n_rows // SELL_SLICE)
    lens = np.bincount(row, minlength=n_slices * SELL_SLICE)
    width = lens.reshape(n_slices, SELL_SLICE).max(axis=1)
    slice_ptr = np.zeros(n_slices + 1, np.int64)
    np.cumsum(width * SELL_SLICE, out=slice_ptr[1:])
    order = np.argsort(row, kind="stable")           # COO order in a row
    starts = np.cumsum(lens) - lens
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - starts[row[order]]
    slot = (slice_ptr[row // SELL_SLICE] + rank * SELL_SLICE
            + row % SELL_SLICE)
    n_slots = int(slice_ptr[-1])
    cols = np.zeros(n_slots, np.int32)
    cols[slot] = col
    spos = np.full(len(p), -1, np.int64)
    spos[keep] = slot
    return SellLayout(n_rows, n_slots, slice_ptr, cols, spos)


class BellLayout(NamedTuple):
    """A block-ELL plan placed for a device: the reference's ``(meta,
    block_cols, perm)`` on the host (the fill gate reads ``meta``; only the
    checks against the dense tiles read the other two) and the sliced-ELL
    layout, on the device, that the kernel and the backward read."""
    meta: BellMeta
    block_cols: np.ndarray     # int32 (n_rb, k), host
    perm: np.ndarray           # int64 (nnz,), host
    sell: SellLayout


def bell_to_device(bell, device) -> BellLayout:
    """``(meta, block_cols, perm)`` (from :func:`build_bell`) as a
    :class:`BellLayout` whose sliced-ELL layout, built from them (reused when
    ``bell`` is already a :class:`BellLayout`), lies on ``device``."""
    meta, block_cols, perm = bell[:3]
    sell = bell.sell if isinstance(bell, BellLayout) else \
        build_sell(meta, block_cols, perm)
    return BellLayout(meta, to_numpy(block_cols).astype(np.int32),
                      to_numpy(perm).astype(np.int64), sell.to(device))


# ---------------------------------------------------------------------------
# SparseTensor
# ---------------------------------------------------------------------------

def _index_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.array(a, dtype=np.int64), device=device)


def _plan_cache():
    """Fresh bounded-LRU plan cache (imported lazily: dispatch imports this
    module at module level)."""
    from .dispatch import PlanCache
    return PlanCache()


class SparseTensor:
    """A sparse matrix in COO form with an autograd-aware solve.

    Construction is eager w.r.t. the *pattern*; ``with_values`` swaps in new
    (possibly grad-requiring) values and SHARES the plan cache, so one
    analysis serves a training loop.  ``device`` defaults to ``"cuda"`` and
    raises when no card is present — pass ``device="cpu"`` explicitly.
    """

    def __init__(self, val, row, col, shape: Sequence[int], *,
                 props: Optional[dict] = None,
                 bell: Optional[tuple] = None,
                 stencil: Optional[Any] = None,
                 build_kernel_layout: bool = False,
                 validate: bool = True,
                 device=None):
        dev = resolve_device(device)
        if isinstance(val, torch.Tensor):
            val = val.to(dev)          # differentiable move
        else:
            val = torch.as_tensor(np.array(val), device=dev)
        self.val = val
        self.row = _index_tensor(row, dev)
        self.col = _index_tensor(col, dev)
        self.shape = tuple(int(s) for s in shape)
        if validate and not (val.shape[-1] == self.row.shape[0]
                             == self.col.shape[0]):
            raise ValueError(
                f"nnz mismatch: val {tuple(val.shape)}, row "
                f"{tuple(self.row.shape)}, col {tuple(self.col.shape)}")
        self.props = props if props is not None else detect_properties(
            val, self.row, self.col, self.shape)
        self.stencil = stencil
        self._plans = _plan_cache()  # plan_key → SolverPlan (bounded LRU)
        if bell is not None:
            self.bell = bell_to_device(bell, dev)
        elif build_kernel_layout:
            self.bell = bell_to_device(
                build_bell(self.row, self.col, self.shape), dev)
        else:
            self.bell = None

    # -- basic ops ----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def batch_shape(self):
        return tuple(self.val.shape[:-1])

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.row.device

    @property
    def T(self) -> "SparseTensor":
        obj = SparseTensor.__new__(SparseTensor)
        obj.val, obj.row, obj.col = self.val, self.col, self.row
        obj.shape = (self.shape[1], self.shape[0])
        obj.props = self.props
        obj.bell, obj.stencil = None, None
        obj._plans = _plan_cache()
        return obj

    def with_values(self, val) -> "SparseTensor":
        """Same pattern, new values.  The plan cache is SHARED with the
        parent — a training loop re-solves without re-analyzing."""
        obj = SparseTensor.__new__(SparseTensor)
        obj.val, obj.row, obj.col = val, self.row, self.col
        obj.shape, obj.props = self.shape, dict(self.props)
        obj.bell, obj.stencil = self.bell, self.stencil
        obj._plans = self._plans
        return obj

    def matvec(self, x, *, backend: Optional[str] = None):
        from . import dispatch
        return dispatch.matvec(self, x, backend=backend)

    def __matmul__(self, x):
        return self.matvec(x)

    def rmatvec(self, y):
        return coo_rmatvec(self.val, self.row, self.col, y, self.shape[1])

    def todense(self):
        return coo_to_dense(self.val, self.row, self.col, self.shape)

    def diagonal(self):
        return coo_diagonal(self.val, self.row, self.col, self.shape[0])

    # -- solvers (autograd-aware; see core/adjoint.py) ----------------------
    def plan(self, **solve_kwargs):
        """Analyze (or fetch the cached) plan for this pattern + options."""
        from . import dispatch
        return dispatch.get_plan(self, dispatch.make_config(self, **solve_kwargs))

    def solve(self, b, *, backend: Optional[str] = None,
              method: Optional[str] = None, tol: float = 1e-6,
              atol: float = 0.0, maxiter: Optional[int] = None,
              precond: str = "jacobi", x0=None):
        """Differentiable solve of ``A x = b`` through the plan engine.

        ``backend`` ∈ {auto, dense, direct, jnp, pallas, stencil};
        ``method`` ∈ {cg, bicgstab, gmres} on the iterative backends;
        ``precond`` ∈ {none, jacobi, block_jacobi, chebyshev, mg, amg, ilu}
        there (``mg`` needs the stencil layout; ``ilu`` is ILU(0)/IC(0) on
        the direct solver's machinery).  Gradients
        w.r.t. ``val`` and ``b`` come from ONE adjoint solve; the direct
        backend's adjoint runs on the forward's factors."""
        from . import adjoint, dispatch
        cfg = dispatch.make_config(self, backend=backend, method=method,
                                   tol=tol, atol=atol, maxiter=maxiter,
                                   precond=precond)
        return adjoint.sparse_solve(cfg, self, b, x0)

    def slogdet(self):
        """(sign, log|det|): sparse via the plan engine's cached LDLᵀ/LU
        factors (Σ log |d_i| with sign tracking, 2x2 pivot blocks included)
        for square patterns within the ``direct_budget`` option; dense
        fallback beyond.  Differentiable in ``val``."""
        from . import adjoint
        return adjoint.sparse_slogdet(self)

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz}, "
                f"batch={self.batch_shape}, dtype={self.dtype}, "
                f"device={self.device}, sym={self.props.get('symmetric')}, "
                f"bell={self.bell is not None})")
