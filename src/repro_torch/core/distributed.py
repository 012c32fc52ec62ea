"""Distributed layer with autograd-compatible halo exchange (port of
``repro.core.distributed``; paper §3.3, App. C).

Domain decomposition as in PETSc/Trilinos/OpenFOAM: each shard owns a
contiguous row block plus halo metadata; a halo exchange runs before each
local SpMV; global inner products are all-reduces.  The halo exchange H is a
``torch.autograd.Function`` whose backward is the transposed exchange Hᵀ —
reversed sender/receiver roles with a sum at the receive site (paper
Eq. 5–6) — so every distributed solve composes with autograd.

Layout.  As in the reference, every distributed array is a stack with a
leading shard axis of length P.  The world is a ``torch.distributed``
process group of W ranks (W divides P); each rank holds the rows
``[rank·P/W, (rank+1)·P/W)`` of every stack, on its own device.  Within a
rank a halo exchange between neighbouring shards is a shifted slice of the
stack; across ranks only the edge shards' tails and heads move, point to
point (``dist.batch_isend_irecv``).  Edges are non-periodic: the first and
last shards see zeros.  :func:`make_mesh` replaces the reference's
``jax.make_mesh((P,), ("data",))``: ``group=None`` is one process and no
collective library; a one-rank NCCL group on the card sends every
all-reduce and all-gather through NCCL; a gloo group runs ranks on the CPU.

Global reductions give the same bits for any W: each shard's partial dot is
computed per shard (the lane-batched ``fused_dots2``, shards as lanes), each
rank writes its partials into its own slots of a zeroed ``(P,)`` vector, the
ranks all-reduce-sum it (adding zeros is exact), and every rank sums the
same P partials.  So x, λ, gradients and iteration counts are identical
between W = 1 and W = 2.

The local product.  At analyze time the rank's stacked local matrices
become ONE block-diagonal operator — rows ``q·n_loc + lrow``, columns
``q·n_ext + lcol`` into the halo-extended stack (``n_ext = h_lo + n_loc +
h_hi``), padding entries dropped — so a matvec is one ``bell_spmv`` launch
for all local shards on the card (its sliced-ELL layout) and one
``coo_matvec`` on the CPU.

Plan lifecycle: ``DSparseTensor.solve`` routes through the plan engine's
``dist`` backend — analyze(pattern) once per (global pattern, P, n_loc),
freezing the partition, the :class:`HaloProgram` (neighbour ranks baked
in), the local operator, the Aᵀ partition for non-symmetric adjoints and
a :class:`~repro_torch.core.precond.DistPreconditionerPlan`; setup(values)
memoized per values tensor; solve(b) the Krylov loop.  ``pipelined_cg``
(Ghysels–Vanroose) takes ONE reduction per iteration.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import dispatch as _dispatch
from . import solvers as _solvers
from ._device import resolve_device, to_numpy
from .sparse import (SellLayout, SparseTensor, coo_matvec, detect_properties,
                     sell_from_coo)

__all__ = ["Mesh", "make_mesh", "halo_exchange", "HaloProgram",
           "halo_program", "halo_apply", "DSparseTensor", "DSparseTensorList",
           "DistMeta", "partition_simple", "partition_coordinate",
           "global_entries", "pipelined_cg"]


# ---------------------------------------------------------------------------
# the mesh: P shards over the W ranks of a process group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """P shards of one named axis over the ranks of ``group`` (None: one
    process, no collectives).  Rank ``rank`` holds shards ``[q0, q0 +
    p_loc)`` on ``device``."""
    p: int
    axis: str
    group: object
    device: torch.device
    world: int
    rank: int

    @property
    def shape(self) -> dict:
        return {self.axis: self.p}

    @property
    def p_loc(self) -> int:
        return self.p // self.world

    @property
    def q0(self) -> int:
        return self.rank * self.p_loc

    @property
    def shards(self) -> slice:
        return slice(self.q0, self.q0 + self.p_loc)

    def peer(self, rank: int) -> int:
        """Global rank of group rank ``rank`` (the P2P address)."""
        import torch.distributed as dist
        return dist.get_global_rank(self.group, rank)


def make_mesh(p: int, axis: str = "data", *, group=None,
              device=None) -> Mesh:
    """A mesh of ``p`` shards on ``axis``.  ``group``: a ``torch.
    distributed`` process group whose world size W divides ``p`` (None: one
    process).  ``device`` defaults to ``cuda`` and raises without a card."""
    dev = resolve_device(device)
    if group is None:
        world, rank = 1, 0
    else:
        import torch.distributed as dist
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    if p < 1 or p % world:
        raise ValueError(f"make_mesh: {p} shards do not split over "
                         f"{world} ranks")
    return Mesh(p=int(p), axis=axis, group=group, device=dev, world=world,
                rank=rank)


def _shard_sum(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """Global sum of per-shard partials ``part`` (P_loc, ...): written into
    this rank's slots of a zeroed (P, ...) stack, all-reduced (adding zeros
    is exact), summed over the shard axis — the same bits on every rank and
    for every W."""
    if mesh.world == 1:                  # this rank's slots are all of them
        full = part.contiguous()
    else:
        full = part.new_zeros((mesh.p,) + tuple(part.shape[1:]))
        full[mesh.shards] = part
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(full, group=mesh.group)
    return _seq_sum(full, 0)


def _seq_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right sum along ``dim`` (a cumulative sum's last entry) —
    the order of the reference's XLA CPU reductions, so CPU iteration
    counts follow the reference's."""
    return t.cumsum(dim).select(dim, -1)


def _gather_shards(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """All-gather of the ranks' stack rows: (P_loc, ...) → (P, ...)."""
    if mesh.group is None:
        return local
    import torch.distributed as dist
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# the paper's H / Hᵀ pair — driven by a frozen HaloProgram
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloProgram:
    """Frozen halo-exchange schedule: the halo widths, the shard counts and
    the neighbour ranks (global ranks for the point-to-point calls; None at
    the ends of the world), fixed at analyze time."""
    h_lo: int
    h_hi: int
    axis: str
    p: int
    p_loc: int
    prev: Optional[int]      # rank holding shard q0 − 1
    next: Optional[int]      # rank holding shard q0 + p_loc
    group: object = dataclasses.field(default=None, compare=False)


@functools.lru_cache(maxsize=None)
def _halo_program(h_lo, h_hi, axis, p, p_loc, prev, next_, group):
    return HaloProgram(h_lo=h_lo, h_hi=h_hi, axis=axis, p=p, p_loc=p_loc,
                       prev=prev, next=next_, group=group)


def halo_program(h_lo: int, h_hi: int, mesh: Mesh) -> HaloProgram:
    """The (cached) halo program of ``mesh``'s rank for halo widths
    (h_lo, h_hi)."""
    prev = mesh.peer(mesh.rank - 1) if mesh.rank > 0 else None
    nxt = mesh.peer(mesh.rank + 1) if mesh.rank < mesh.world - 1 else None
    return _halo_program(int(h_lo), int(h_hi), mesh.axis, mesh.p,
                         mesh.p_loc, prev, nxt, mesh.group)


def _exchange(prog: HaloProgram, sends, recvs):
    """One batch of point-to-point calls: ``sends`` are (peer, tensor)
    pairs, ``recvs`` (peer, like) pairs (a None peer — the end of the
    world — is skipped, and its receive comes back None)."""
    import torch.distributed as dist
    ops, got = [], []
    for peer, t in sends:
        if peer is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer,
                                  prog.group))
    for peer, like in recvs:
        buf = None
        if peer is not None:
            buf = torch.empty_like(like, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, buf, peer, prog.group))
        got.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def _halo_run(prog: HaloProgram, x: torch.Tensor) -> torch.Tensor:
    """H: ``x`` (P_loc, ..., n_loc) owned values → (P_loc, ..., h_lo + n_loc
    + h_hi): [left neighbour's tail | own | right neighbour's head]."""
    n_loc = x.shape[-1]
    lo = x[..., n_loc - prog.h_lo:]             # every shard's tail
    hi = x[..., :prog.h_hi]                     # every shard's head
    # across ranks only the edge shards move: the last shard's tail goes
    # to the next rank, the first shard's head to the previous one
    sends, recvs = [], []
    if prog.h_lo:
        sends.append((prog.next, lo[-1]))
        recvs.append((prog.prev, lo[0]))
    if prog.h_hi:
        sends.append((prog.prev, hi[0]))
        recvs.append((prog.next, hi[-1]))
    got = iter(_exchange(prog, sends, recvs))
    parts = []
    if prog.h_lo:
        left = torch.zeros_like(lo)
        left[1:] = lo[:-1]
        tail = next(got)
        if tail is not None:
            left[0] = tail
        parts.append(left)
    parts.append(x)
    if prog.h_hi:
        right = torch.zeros_like(hi)
        right[:-1] = hi[1:]
        head = next(got)
        if head is not None:
            right[-1] = head
        parts.append(right)
    return torch.cat(parts, -1)


def _halo_run_t(prog: HaloProgram, g: torch.Tensor) -> torch.Tensor:
    """Hᵀ: the same neighbour graph and message sizes, reversed roles, a sum
    at the receive site (paper Eq. 6).  ``g`` (P_loc, ..., n_ext)."""
    n_loc = g.shape[-1] - prog.h_lo - prog.h_hi
    g_lo = g[..., :prog.h_lo]
    g_hi = g[..., prog.h_lo + n_loc:]
    gx = g[..., prog.h_lo:prog.h_lo + n_loc].clone()
    # my lo-halo grads belong to the left neighbour's tail, my hi-halo
    # grads to the right neighbour's head; the lo sums go first, as in H's
    # own order, so an overlapping entry adds in the same order for any W
    sends, recvs = [], []
    if prog.h_lo:
        sends.append((prog.prev, g_lo[0]))
        recvs.append((prog.next, g_lo[-1]))
    if prog.h_hi:
        sends.append((prog.next, g_hi[-1]))
        recvs.append((prog.prev, g_hi[0]))
    got = iter(_exchange(prog, sends, recvs))
    if prog.h_lo:
        gx[:-1, ..., n_loc - prog.h_lo:] += g_lo[1:]
        from_next = next(got)
        if from_next is not None:
            gx[-1, ..., n_loc - prog.h_lo:] += from_next
    if prog.h_hi:
        gx[1:, ..., :prog.h_hi] += g_hi[:-1]
        from_prev = next(got)
        if from_prev is not None:
            gx[0, ..., :prog.h_hi] += from_prev
    return gx


class _HaloApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, prog):
        ctx.prog = prog
        return _halo_run(prog, x)

    @staticmethod
    def backward(ctx, g):
        return _halo_run_t(ctx.prog, g.contiguous()), None


def halo_apply(prog: HaloProgram, x: torch.Tensor) -> torch.Tensor:
    """Differentiable H with the frozen program; its backward is Hᵀ."""
    return _HaloApply.apply(x, prog)


def halo_exchange(x: torch.Tensor, h_lo: int, h_hi: int,
                  mesh: Mesh) -> torch.Tensor:
    """H on a stack ``x`` (P_loc, ..., n_loc) with the program of
    ``mesh``'s rank (differentiable)."""
    return halo_apply(halo_program(h_lo, h_hi, mesh), x)


# ---------------------------------------------------------------------------
# partitioning utilities (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def partition_simple(n: int, p: int) -> np.ndarray:
    """Contiguous row-block ownership boundaries (paper partition_simple)."""
    base = n // p
    sizes = np.full(p, base)
    sizes[: n - base * p] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def partition_coordinate(coords: np.ndarray, p: int) -> np.ndarray:
    """Recursive coordinate bisection (Berger–Bokhari 1987): a permutation
    making each partition contiguous, so the banded halo machinery applies
    after relabeling."""
    n = coords.shape[0]
    order = np.arange(n)

    def rcb(idx, parts):
        if parts == 1:
            return [idx]
        d = int(np.argmax(coords[idx].max(0) - coords[idx].min(0)))
        srt = idx[np.argsort(coords[idx, d], kind="stable")]
        half = parts // 2
        cut = len(idx) * half // parts
        return rcb(srt[:cut], half) + rcb(srt[cut:], parts - half)

    groups = rcb(order, p)
    return np.concatenate(groups)


def _partition_pattern(row: np.ndarray, col: np.ndarray, bounds: np.ndarray):
    """Row-block partition of one COO pattern (values-free).

    Returns ``(lrow, lcol, src, h_lo, h_hi, nnz_loc, counts)`` where ``src``
    maps each padded local slot back to its global entry index (pads → -1).
    Shared by ``from_global`` and the plan's Aᵀ-partition build."""
    p = len(bounds) - 1
    n_loc = int(np.max(np.diff(bounds)))
    masks = [(row >= bounds[q]) & (row < bounds[q + 1]) for q in range(p)]
    h_lo = h_hi = 0
    for q, m in enumerate(masks):
        if m.any():
            h_lo = max(h_lo, int(max(0, bounds[q] - col[m].min())))
            h_hi = max(h_hi, int(max(0, col[m].max() - (bounds[q + 1] - 1))))
    if h_lo > n_loc or h_hi > n_loc:
        raise ValueError(
            "halo wider than one neighbour shard — repartition or add hops")
    counts = [int(m.sum()) for m in masks]
    nnz_loc = max(max(counts), 1)
    lrow = np.zeros((p, nnz_loc), np.int32)
    lcol = np.zeros((p, nnz_loc), np.int32)
    src = np.full((p, nnz_loc), -1, np.int64)
    for q, m in enumerate(masks):
        idx = np.nonzero(m)[0]
        lrow[q, :idx.size] = row[idx] - bounds[q]
        lcol[q, :idx.size] = col[idx] - bounds[q] + h_lo
        src[q, :idx.size] = idx
    return lrow, lcol, src, h_lo, h_hi, nnz_loc, counts


@dataclasses.dataclass(frozen=True)
class DistMeta:
    n: int
    p: int
    n_loc: int          # padded local rows (uniform)
    h_lo: int
    h_hi: int
    nnz_loc: int        # padded local nnz (uniform)
    axis: str
    symmetric: bool
    shard_nnz: Optional[Tuple[int, ...]] = None   # true nnz per shard

    @property
    def n_ext(self) -> int:
        return self.h_lo + self.n_loc + self.h_hi


def global_entries(lrow, lcol, meta: DistMeta, bounds):
    """Stacked local pattern (P, nnz_loc) → global COO coordinates
    (values-free).  Returns ``(row_g, col_g, fa)``, ``fa`` each entry's flat
    index into the (P·nnz_loc,) value storage; padding is trimmed via
    ``meta.shard_nnz``."""
    lr = to_numpy(lrow)
    lc = to_numpy(lcol)
    p, nnz_loc = lr.shape
    rows, cols, fa = [], [], []
    for q in range(p):
        cnt = meta.shard_nnz[q] if meta.shard_nnz is not None else nnz_loc
        rows.append(lr[q, :cnt].astype(np.int64) + bounds[q])
        cols.append(lc[q, :cnt].astype(np.int64) - meta.h_lo + bounds[q])
        fa.append(q * nnz_loc + np.arange(cnt, dtype=np.int64))
    row_g = np.concatenate(rows)
    col_g = np.concatenate(cols)
    fa = np.concatenate(fa)
    ok = (col_g >= 0) & (col_g < meta.n)
    return row_g[ok], col_g[ok], fa[ok]


def _valid_mask(meta: DistMeta, shards: slice) -> np.ndarray:
    """(P_loc, nnz_loc) True on the true entries of the shards (pads
    False)."""
    cnt = np.asarray(meta.shard_nnz)[shards]
    return np.arange(meta.nnz_loc)[None, :] < cnt[:, None]


# ---------------------------------------------------------------------------
# the local product: one block-diagonal operator for the rank's shards
# ---------------------------------------------------------------------------

class LocalOp:
    """The rank's stacked local matrices as ONE block-diagonal operator of
    ``P_loc·n_loc`` rows and ``P_loc·n_ext`` columns (of the halo-extended
    stack).  ``vidx`` are the flat slots (of the (P_loc·nnz_loc,) values)
    of the true entries, ``row``/``col`` their block-diagonal coordinates.
    On CUDA the product is one ``bell_spmv`` launch on ``sell`` (built at
    analyze time, pads left out: their ``spos`` is −1); on the CPU it is
    ``coo_matvec`` (the kernel's plain counterpart on the stack)."""

    def __init__(self, meta: DistMeta, lrow, lcol, mesh: Mesh):
        p_loc, n_loc, n_ext = mesh.p_loc, meta.n_loc, meta.n_ext
        self.p_loc, self.n_loc, self.n_ext = p_loc, n_loc, n_ext
        lr = to_numpy(lrow)[mesh.shards].astype(np.int64)
        lc = to_numpy(lcol)[mesh.shards].astype(np.int64)
        q = np.arange(p_loc, dtype=np.int64)[:, None]
        keep = np.flatnonzero(_valid_mask(meta, mesh.shards))
        row = (q * n_loc + lr).reshape(-1)[keep]
        col = (q * n_ext + lc).reshape(-1)[keep]
        dev = mesh.device
        self.device = dev
        self.n_rows, self.n_cols = p_loc * n_loc, p_loc * n_ext
        self.nnz_all = p_loc * meta.nnz_loc
        self.vidx = torch.as_tensor(keep, device=dev)
        self.row = torch.as_tensor(row, device=dev)
        self.col = torch.as_tensor(col, device=dev)
        self.sell: Optional[SellLayout] = None
        self._tsell: Optional[SellLayout] = None
        if dev.type == "cuda":
            self.sell = sell_from_coo(row, col, self.n_rows, keep,
                                      self.nnz_all).to(dev)

    def tsell(self) -> SellLayout:
        """Sliced-ELL layout of the operator's transpose (built on first
        use: only a differentiated ``DSparseTensor.matvec`` needs it)."""
        if self._tsell is None:
            self._tsell = sell_from_coo(
                to_numpy(self.col), to_numpy(self.row), self.n_cols,
                to_numpy(self.vidx), self.nnz_all).to(self.device)
        return self._tsell

    def pack(self, lval: torch.Tensor):
        """The values in the kernel's layout (CUDA), None on the CPU."""
        if self.sell is None:
            return None
        from ..kernels import ops as kops
        return kops.sell_assemble(self.sell, lval.reshape(-1))

    def apply(self, lval, packed, x_ext: torch.Tensor) -> torch.Tensor:
        """y (P_loc, n_loc) = the local product of the halo-extended stack
        ``x_ext`` (P_loc, n_ext); not differentiable."""
        flat = x_ext.reshape(-1)
        if x_ext.device.type == "cpu":
            y = coo_matvec(lval.reshape(-1)[self.vidx], self.row, self.col,
                           flat, self.n_rows)
        else:
            from ..kernels import ops as kops
            if packed is None:
                packed = self.pack(lval)
            y = kops.sell_product(self.sell, packed, flat.contiguous(),
                                  self.n_rows)
        return y.view(self.p_loc, self.n_loc)

    def apply_t(self, lval, g: torch.Tensor) -> torch.Tensor:
        """The transpose product: (P_loc, n_loc) → (P_loc, n_ext)."""
        flat = g.reshape(-1)
        if g.device.type == "cpu":
            y = coo_matvec(lval.reshape(-1)[self.vidx], self.col, self.row,
                           flat, self.n_cols)
        else:
            from ..kernels import ops as kops
            ts = self.tsell()
            y = kops.sell_product(ts, kops.sell_assemble(ts, lval.reshape(-1)),
                                  flat.contiguous(), self.n_cols)
        return y.view(self.p_loc, self.n_ext)

    def entry_grad(self, lval, left, right_ext) -> torch.Tensor:
        """(P_loc, nnz_loc): ``left[row] · right_ext[col]`` on the true
        entries, 0 on the pads — the gradient assembly's product."""
        g = lval.new_zeros(self.nnz_all)
        g[self.vidx] = left.reshape(-1)[self.row] * \
            right_ext.reshape(-1)[self.col]
        return g.view(lval.shape)


class _StackMatvec(torch.autograd.Function):
    """y = A_loc(lval)·x_ext on the local operator, differentiable in both."""

    @staticmethod
    def forward(ctx, lval, x_ext, op):
        ctx.op = op
        ctx.save_for_backward(lval, x_ext)
        return op.apply(lval, None, x_ext)

    @staticmethod
    def backward(ctx, g):
        lval, x_ext = ctx.saved_tensors
        op = ctx.op
        gval = gx = None
        if ctx.needs_input_grad[0]:
            gval = op.entry_grad(lval, g, x_ext)
        if ctx.needs_input_grad[1]:
            gx = op.apply_t(lval, g)
        return gval, gx, None


def _local_matvec(op: LocalOp, prog: HaloProgram, lval, packed, x,
                  differentiable: bool = False):
    """halo exchange + the purely local SpMV (paper Eq. 5) on a stack x
    (P_loc, n_loc)."""
    if differentiable:
        return _StackMatvec.apply(lval, halo_apply(prog, x), op)
    return op.apply(lval, packed, _halo_run(prog, x))


def _shard_dots(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-shard <u, v> of stacks (L, n_loc) → (L,): on the card one
    lane-batched ``fused_dots2`` launch (shards as lanes), on the CPU a
    left-to-right sum per shard (:func:`_seq_sum`).  Either way lane q's sum
    depends on its own row only, so a shard's partial is the same bits
    whatever the number of shards a rank holds."""
    return _stack_dots2(u[None], v)[0][0]


# ---------------------------------------------------------------------------
# DSparseTensor
# ---------------------------------------------------------------------------

class DSparseTensor:
    """Row-block distributed sparse matrix (paper §3.3).

    Storage: this rank's rows of the stacked per-shard arrays —
    ``lval`` (P_loc, nnz_loc) values, ``lrow`` local row ids and ``lcol``
    indices into the halo-extended local vector, on ``mesh.device``.  The
    whole pattern's stacks (P, nnz_loc) stay on the host (``row``/``col``):
    every rank runs the values-free analysis on them.  Single-neighbour
    halos (h_lo, h_hi ≤ n_loc) are asserted at construction.

    Solves route through the plan engine's ``dist`` backend: the first call
    analyzes the (pattern, P, partition) once and every later solve
    (tolerance sweeps, ``with_values`` refreshes, the adjoint backward)
    reuses the cached plan."""

    bell = None
    stencil = None
    batch_shape = ()

    def __init__(self, meta: DistMeta, lval, lrow, lcol, mesh: Mesh,
                 prow: np.ndarray, pcol: np.ndarray):
        self.meta = meta
        self.lval, self.lrow, self.lcol = lval, lrow, lcol
        self.mesh = mesh
        self._prow, self._pcol = prow, pcol
        from .sparse import _plan_cache
        self._plans = _plan_cache()

    # -- plan-engine protocol (duck-typed SparseTensor pattern surface) ------
    @property
    def val(self):
        return self.lval

    @property
    def row(self):
        """The whole pattern's stacked local rows (P, nnz_loc), host."""
        return self._prow

    @property
    def col(self):
        return self._pcol

    @property
    def shape(self):
        return (self.meta.n, self.meta.n)

    @property
    def props(self):
        return {"symmetric": self.meta.symmetric}

    @property
    def dtype(self):
        return self.lval.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def plan_key_extra(self) -> tuple:
        """Mesh-aware plan-cache key suffix: one pattern partitioned over a
        different axis (or shard count) analyzes separately."""
        return (self.meta.axis, self.meta.p, self.meta.n_loc)

    def with_values(self, lval) -> "DSparseTensor":
        """Same partition + pattern, new stacked values (P_loc, nnz_loc).
        The plan cache is SHARED with the parent, so tolerance sweeps and
        shared-pattern batches do ONE analysis."""
        obj = DSparseTensor.__new__(DSparseTensor)
        obj.meta, obj.mesh = self.meta, self.mesh
        obj.lval, obj.lrow, obj.lcol = lval, self.lrow, self.lcol
        obj._prow, obj._pcol = self._prow, self._pcol
        obj._plans = self._plans
        return obj

    def plan(self, **solve_kwargs) -> "_dispatch.SolverPlan":
        """Analyze (or fetch) the cached plan."""
        return _dispatch.get_plan(self, self._make_config(**solve_kwargs))

    def _make_config(self, *, method: str = "auto", tol: float = 1e-6,
                     atol: float = 0.0, maxiter: int = 1000,
                     precond: str = "jacobi", pipelined: bool = False,
                     x0=None) -> "_dispatch.SolverConfig":
        del x0                       # a solve-stage argument
        if method == "auto":
            method = "cg" if self.meta.symmetric else "bicgstab"
        if pipelined and method == "cg":
            method = "pipelined_cg"
        return _dispatch.SolverConfig(backend="dist", method=method, tol=tol,
                                      atol=atol, maxiter=maxiter,
                                      precond=precond)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_global(cls, val, row, col, shape, mesh, axis: str = "data",
                    symmetric: Optional[bool] = None) -> "DSparseTensor":
        """Partition a global COO matrix over ``mesh`` (a :class:`Mesh`, or
        a shard count P for a one-process mesh on the default device, which
        is the card).  Every rank passes the same global triplet and keeps
        its own shards."""
        if not isinstance(mesh, Mesh):
            mesh = make_mesh(int(mesh), axis)
        val = to_numpy(val)
        row = to_numpy(row).astype(np.int64)
        col = to_numpy(col).astype(np.int64)
        n = shape[0]
        p = mesh.shape[axis]
        if symmetric is None:
            symmetric = detect_properties(val, row, col, shape)["symmetric"]
        bounds = partition_simple(n, p)
        lrow, lcol, src, h_lo, h_hi, nnz_loc, counts = _partition_pattern(
            row, col, bounds)
        rowsz = np.diff(bounds)
        if (h_lo > 0 or h_hi > 0) and rowsz.min() != rowsz.max():
            raise ValueError(
                "halo exchange indexes neighbour tails positionally — "
                "coupled (h>0) partitions need uniform shard sizes "
                f"(n={n} not divisible by P={p})")
        sl = mesh.shards
        s = src[sl]
        lval = np.where(s >= 0, val[np.clip(s, 0, None)], 0.0)
        meta = DistMeta(n=n, p=p, n_loc=int(np.max(rowsz)), h_lo=h_lo,
                        h_hi=h_hi, nnz_loc=nnz_loc, axis=axis,
                        symmetric=bool(symmetric), shard_nnz=tuple(counts))
        dev = mesh.device
        return cls(meta, torch.as_tensor(lval, device=dev),
                   torch.as_tensor(lrow[sl], dtype=torch.int64, device=dev),
                   torch.as_tensor(lcol[sl], dtype=torch.int64, device=dev),
                   mesh, lrow, lcol)

    # -- stacked <-> global --------------------------------------------------
    def stack_vector(self, x_global) -> torch.Tensor:
        """(n,) → this rank's (P_loc, n_loc) rows of the padded stack."""
        m = self.meta
        x = torch.as_tensor(x_global, device=self.mesh.device)
        bounds = partition_simple(m.n, m.p)
        sl = self.mesh.shards
        return torch.stack([
            torch.nn.functional.pad(x[bounds[q]:bounds[q + 1]],
                                    (0, m.n_loc - int(bounds[q + 1]
                                                      - bounds[q])))
            for q in range(sl.start, sl.stop)])

    def gather_global(self, x_stacked) -> torch.Tensor:
        """This rank's (P_loc, n_loc) rows → the global (n,) vector on every
        rank (an all-gather over the ranks)."""
        m = self.meta
        xs = _gather_shards(self.mesh, x_stacked.detach())
        bounds = partition_simple(m.n, m.p)
        return torch.cat([xs[q][: bounds[q + 1] - bounds[q]]
                          for q in range(m.p)])

    def gather_values(self):
        """Stacked local storage → the global COO triplet (numpy), on every
        rank; padding trimmed via ``meta.shard_nnz``."""
        m = self.meta
        bounds = partition_simple(m.n, m.p)
        row_g, col_g, fa = global_entries(self._prow, self._pcol, m, bounds)
        flat = to_numpy(_gather_shards(self.mesh, self.lval.detach())
                        ).reshape(-1)
        return flat[fa], row_g, col_g

    # -- distributed ops ------------------------------------------------------
    def _halo(self) -> HaloProgram:
        return halo_program(self.meta.h_lo, self.meta.h_hi, self.mesh)

    def _local_op(self) -> LocalOp:
        """The local operator of the pattern — a cached plan's when one
        exists, else built and kept."""
        for plan in self._plans.values():
            return plan.artifacts["local"]
        op = getattr(self, "_op", None)
        if op is None:
            op = self._op = LocalOp(self.meta, self._prow, self._pcol,
                                    self.mesh)
        return op

    def matvec(self, x_stacked):
        """A @ x on stacks (P_loc, n_loc), differentiable in the values and
        in x (H forward, Hᵀ backward)."""
        return _local_matvec(self._local_op(), self._halo(), self.lval, None,
                             x_stacked, differentiable=True)

    def solve(self, b_stacked, *, method: str = "auto", tol: float = 1e-6,
              atol: float = 0.0, maxiter: int = 1000, precond: str = "jacobi",
              pipelined: bool = False, x0=None):
        """Distributed, differentiable solve through the plan engine.

        Forward: analyze once (halo program, partition, local operator,
        preconditioner build) → per-values setup (memoized per values
        tensor) → the Krylov loop.  Backward: one distributed solve of
        Aᵀλ = g through ``plan.transpose()`` — the SAME plan for symmetric
        patterns, a shared-artifact Aᵀ-partition sibling otherwise — plus
        the local O(nnz) gradient assembly with halo'd x (paper §3.3).

        ``precond`` ∈ {none, jacobi, schwarz, schwarz2}: ``schwarz`` is
        shard-local overlapping Schwarz with ILU(0)/IC(0) subdomain solves;
        ``schwarz2`` adds a deflated coarse correction (aggregated global
        Galerkin matrix, direct factors replicated on every rank)."""
        from . import adjoint as _adjoint
        cfg = self._make_config(method=method, tol=tol, atol=atol,
                                maxiter=maxiter, precond=precond,
                                pipelined=pipelined)
        return _adjoint.dist_sparse_solve(cfg, self, b_stacked, x0)

    def solve_with_info(self, b_stacked, **kw):
        """Non-differentiable solve that also returns :class:`SolveInfo`
        (all-reduced residual norm and iteration count, the same on every
        rank)."""
        cfg = self._make_config(**kw)
        plan = _dispatch.get_plan(self, cfg)
        return plan.solve(self, b_stacked, kw.get("x0"), cfg=cfg)

    def eigsh(self, k: int = 4, *, tol: float = 1e-6, maxiter: int = 200,
              seed: int = 0):
        """Distributed LOBPCG: all-reduced Gram matrices for the
        Rayleigh–Ritz steps, halo-exchange matvecs.  Returns ``(w (k,),
        V (P_loc, n_loc, k))``; eigenvalue gradients by Hellmann–Feynman,
        assembled locally (eigenvector cotangents are not propagated, as in
        the reference).  The start block is drawn per shard q from a CPU
        generator seeded ``seed + q``, so it does not depend on W."""
        return _DistEigsh.apply(self.lval, self, k, tol, maxiter, seed)

    def slogdet(self):
        """Gather-based fallback (paper §3.3, 'Scope of distributed
        gradients'): pulls the global matrix onto every rank, rebuilds a
        :class:`SparseTensor` and delegates to its slogdet (sparse LDLᵀ
        within the ``direct_budget`` option, dense beyond).  Warned; the
        gather breaks gradient flow into the stacked values."""
        warnings.warn("DSparseTensor.slogdet gathers the global matrix onto "
                      "one process — not distributed-scalable (sparse LDLT "
                      "within the direct_budget option, dense O(n^2) "
                      "beyond).")
        val, row, col = self.gather_values()
        return SparseTensor(val, row, col, self.shape,
                            device=self.mesh.device).slogdet()


class _DistEigsh(torch.autograd.Function):
    """LOBPCG forward, Hellmann–Feynman backward: ∂λ_k/∂A_ij = v_ki v_kj,
    each shard's entries from its own rows and its halo'd vectors."""

    @staticmethod
    def forward(ctx, lval, D, k, tol, maxiter, seed):
        m, mesh = D.meta, D.mesh
        p_loc, n_loc = mesh.p_loc, m.n_loc
        op, prog = D._local_op(), D._halo()
        packed = op.pack(lval)
        lv = lval.detach()

        def mv(x):
            return _local_matvec(op, prog, lv, packed,
                                 x.view(p_loc, n_loc)).reshape(-1)

        def gram(S1, S2):
            # per-shard S1_q S2_qᵀ, summed over all shards in one reduction
            a, b = S1.shape[0], S2.shape[0]
            s1 = S1.view(a, p_loc, n_loc).transpose(0, 1).contiguous()
            s2 = S2.view(b, p_loc, n_loc).transpose(0, 1).contiguous()
            return _shard_sum(mesh, torch.stack(
                [s1[q] @ s2[q].T for q in range(p_loc)]))

        X0 = torch.stack([
            _solvers.seeded_normal((k, n_loc), lval.dtype, mesh.device,
                                   seed + q)
            for q in range(mesh.q0, mesh.q0 + p_loc)], 1).reshape(k, -1)
        with torch.no_grad():
            w, X, _ = _solvers.lobpcg_general(mv, X0, gram=gram, tol=tol,
                                              maxiter=maxiter)
        V = X.view(k, p_loc, n_loc).permute(1, 2, 0).contiguous()
        ctx.D = D
        ctx.save_for_backward(lval, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        lval, V = ctx.saved_tensors
        D = ctx.D
        if gw is None:
            return (None,) * 6
        op, prog = D._local_op(), D._halo()
        Vx = V.permute(0, 2, 1)                         # (P_loc, k, n_loc)
        V_ext = _halo_run(prog, Vx.contiguous())        # (P_loc, k, n_ext)
        left = (gw[None, :, None] * Vx).transpose(1, 2)   # (P_loc, n_loc, k)
        right = V_ext.transpose(1, 2)                     # (P_loc, n_ext, k)
        g = lval.new_zeros(op.nnz_all)
        g[op.vidx] = (left.reshape(-1, left.shape[-1])[op.row]
                      * right.reshape(-1, right.shape[-1])[op.col]).sum(-1)
        return g.view(lval.shape), None, None, None, None, None


# ---------------------------------------------------------------------------
# plan-engine stages (called by dispatch.DistBackend)
# ---------------------------------------------------------------------------

def dist_analyze(cfg, plan) -> dict:
    """analyze(pattern): freeze every values-free artifact for one (global
    pattern, P, partition) — runs once, cached on the plan."""
    from .precond import DistPreconditionerPlan
    meta, mesh = plan.dmeta, plan.mesh
    bounds = partition_simple(meta.n, meta.p)
    return {
        "halo": halo_program(meta.h_lo, meta.h_hi, mesh),
        "bounds": bounds,
        "local": LocalOp(meta, plan.row, plan.col, mesh),
        "precond": DistPreconditionerPlan(cfg.precond, plan.row, plan.col,
                                          meta, bounds=bounds, mesh=mesh),
        "transposed": False,
        # non-symmetric only: the Aᵀ partition, built on the FIRST
        # plan.transpose() and cached here for the plan's lifetime
        **({"t": None} if not meta.symmetric else {}),
    }


def _build_t_partition(cfg, plan, meta: DistMeta, bounds) -> dict:
    """The Aᵀ partition as a plan artifact (numpy, once per pattern): the
    transpose of the global pattern, row-block partitioned with its OWN halo
    widths and padding, and a gather map from the forward values' flat
    (P·nnz_loc,) storage (+ a zero slot) to the rank's Aᵀ stacks."""
    from .precond import DistPreconditionerPlan
    _dispatch.PLAN_STATS["t_partition"] += 1
    mesh = plan.mesh
    p, nnz_loc = plan.row.shape
    row_g, col_g, fa = global_entries(plan.row, plan.col, meta, bounds)
    lrow_t, lcol_t, src_t, h_lo_t, h_hi_t, nnz_loc_t, counts_t = \
        _partition_pattern(col_g, row_g, bounds)
    gather = np.where(src_t >= 0, fa[np.clip(src_t, 0, None)],
                      p * nnz_loc).astype(np.int64)
    t_meta = DistMeta(n=meta.n, p=meta.p, n_loc=meta.n_loc, h_lo=h_lo_t,
                      h_hi=h_hi_t, nnz_loc=nnz_loc_t, axis=meta.axis,
                      symmetric=False, shard_nnz=tuple(counts_t))
    return {
        "meta": t_meta,
        "lrow": lrow_t,
        "lcol": lcol_t,
        "gather": torch.as_tensor(gather[mesh.shards], device=mesh.device),
        "halo": halo_program(h_lo_t, h_hi_t, mesh),
        "local": LocalOp(t_meta, lrow_t, lcol_t, mesh),
        "precond": DistPreconditionerPlan(cfg.precond, lrow_t, lcol_t,
                                          t_meta, bounds=bounds, mesh=mesh),
    }


def dist_transpose_plan(plan):
    """Adjoint plan from the forward plan's own artifacts — zero
    re-analysis: a sibling whose pattern IS the plan's cached Aᵀ partition
    (built on first use).  Symmetric patterns never reach here."""
    if "t" not in plan.artifacts:
        return None
    if plan.artifacts["t"] is None:
        plan.artifacts["t"] = _build_t_partition(
            plan.cfg, plan, plan.dmeta, plan.artifacts["bounds"])
    t = plan.artifacts["t"]
    SolverPlan = _dispatch.SolverPlan
    tp = SolverPlan.__new__(SolverPlan)
    tp.cfg = plan.cfg
    tp.backend = plan.backend
    tp.row, tp.col = t["lrow"], t["lcol"]
    tp.shape = (plan.shape[1], plan.shape[0])
    tp.props = dict(plan.props)
    tp.bell = tp.stencil = None
    tp.mesh = plan.mesh
    tp.dmeta = t["meta"]
    tmeta = t["meta"]
    tp._cache = {tp.cfg.plan_key() + (tmeta.axis, tmeta.p, tmeta.n_loc): tp}
    tp._tplan = plan
    tp._setup_memo = {}     # Aᵀ values differ from the forward values
    tp.artifacts = {"halo": t["halo"], "bounds": plan.artifacts["bounds"],
                    "local": t["local"], "precond": t["precond"],
                    "transposed": True}
    return tp


def transpose_values(plan, lval: torch.Tensor) -> torch.Tensor:
    """Forward stacked values → the rank's Aᵀ-partition stacked values via
    the plan's cached gather map (the forward values of every rank are
    all-gathered first: Aᵀ's row block q holds entries of A's neighbouring
    row blocks)."""
    t = plan.artifacts["t"]
    full = _gather_shards(plan.mesh, lval)
    flat = torch.cat([full.reshape(-1), full.new_zeros(1)])
    return flat[t["gather"]]


def transpose_view(tplan, lval_t) -> DSparseTensor:
    """DSparseTensor view of the Aᵀ partition carrying derived values —
    what the adjoint feeds back into ``tplan.solve``."""
    D = DSparseTensor.__new__(DSparseTensor)
    D.meta = tplan.dmeta
    D.mesh = tplan.mesh
    D._prow, D._pcol = tplan.row, tplan.col
    D.lval = lval_t
    D.lrow = D.lcol = None
    D._op = tplan.artifacts["local"]
    D._plans = tplan._cache
    return D


def dist_setup(plan, A) -> tuple:
    """setup(values): the values in the local kernel's layout and the
    preconditioner refresh on the stacked values — memoized per values
    tensor by ``SolverPlan.setup`` (``PLAN_STATS['setup_reuse']``)."""
    return (plan.artifacts["local"].pack(A.lval),
            plan.artifacts["precond"].refresh(A.lval))


def dist_solve(plan, state, A, b, x0, cfg):
    """solve(b): the Krylov loop on this rank's stacks, global dots through
    :func:`_shard_sum`.  ``b``/``x0`` (P_loc, n_loc); returns x (P_loc,
    n_loc) and the SolveInfo every rank shares."""
    meta, mesh = plan.dmeta, plan.mesh
    prog = plan.artifacts["halo"]
    op = plan.artifacts["local"]
    pplan = plan.artifacts["precond"]
    method = cfg.method
    if method not in ("cg", "bicgstab", "pipelined_cg"):
        raise ValueError(f"unknown distributed method {method!r}")
    packed, pstate = state
    lval = A.lval.detach()
    shape = (mesh.p_loc, meta.n_loc)

    def mv_s(x):
        return _local_matvec(op, prog, lval, packed, x)

    def mv(xv):
        return mv_s(xv.view(shape)).reshape(-1)

    def pdot(u, v):
        return _shard_sum(mesh, _shard_dots(u.view(shape), v.view(shape)))

    M_s = pplan.local_closure(pstate, lambda r: _halo_run(prog, r),
                              lambda z: _halo_run_t(prog, z), matvec=mv_s)

    def M(r):
        return M_s(r.view(shape)).reshape(-1)

    bq = b.detach().reshape(-1)
    x0q = None if x0 is None else x0.detach().reshape(-1)
    if method == "pipelined_cg":
        def dots(r, u, w):
            # <r,u>, <w,u> and <r,r> of every shard from ONE lane launch
            d1, d2 = _stack_dots2(torch.stack([r.view(shape), w.view(shape)]),
                                  u.view(shape))
            part = torch.stack([d1[0], d1[1], d2[0]], -1)   # (P_loc, 3)
            return _shard_sum(mesh, part)

        if x0q is None:
            x, info = pipelined_cg(mv, bq, M=M, tol=cfg.tol, atol=cfg.atol,
                                   maxiter=cfg.maxiter, dots=dots, dot=pdot)
        else:
            # warm start by shift, the target relative to the ORIGINAL b
            target = max(cfg.tol * float(torch.sqrt(pdot(bq, bq))),
                         cfg.atol)
            x, info = pipelined_cg(mv, bq - mv(x0q), M=M, tol=0.0,
                                   atol=target, maxiter=cfg.maxiter,
                                   dots=dots, dot=pdot)
            x = x + x0q
    elif method == "cg":
        x, info = _solvers.cg(mv, bq, x0q, M=M, tol=cfg.tol, atol=cfg.atol,
                              maxiter=cfg.maxiter, dot=pdot)
    else:
        x, info = _solvers.bicgstab(mv, bq, x0q, M=M, tol=cfg.tol,
                                    atol=cfg.atol, maxiter=cfg.maxiter,
                                    dot=pdot)
    return x.view(shape), info


def _stack_dots2(U: torch.Tensor, v: torch.Tensor):
    """(<U_j,q, v_q>, <U_j,q, U_j,q>) for a (J, L, n) stack of shard stacks
    against one (L, n) stack, as ONE lane-batched ``fused_dots2`` launch
    over J·L lanes on the card (left-to-right sums on the CPU); each comes
    back (J, L)."""
    if U.device.type == "cpu":
        return _seq_sum(U * v, -1), _seq_sum(U * U, -1)
    from ..kernels import solve_step
    J, L, n = U.shape
    d1, d2 = solve_step.fused_dots2(U.reshape(J * L, n).contiguous(),
                                    v.expand(J, L, n).reshape(J * L, n)
                                    .contiguous())
    return d1.view(J, L), d2.view(J, L)


def assemble_matrix_grad(plan, lam, x) -> torch.Tensor:
    """Local O(nnz) matrix-gradient assembly: −λ_i x_j with halo'd x (paper
    §3.3), on the FORWARD partition's pattern (pads get 0)."""
    op = plan.artifacts["local"]
    x_ext = _halo_run(plan.artifacts["halo"], x)
    lval_like = lam.new_empty(op.p_loc, plan.dmeta.nnz_loc)
    return -op.entry_grad(lval_like, lam, x_ext)


# ---------------------------------------------------------------------------
# DSparseTensorList
# ---------------------------------------------------------------------------

class DSparseTensorList:
    """Distributed batch with distinct patterns — per-element dispatch, but
    members sharing one partitioned pattern (same stacked index arrays,
    meta and mesh) route through ONE plan cache, so a shared-pattern batch
    analyzes once."""

    def __init__(self, tensors):
        self.tensors = list(tensors)

    def _share_plans(self):
        seen = {}
        for A in self.tensors:
            key = (id(A.lrow), id(A.lcol), A.meta, id(A.mesh))
            if key in seen:
                # merge, don't overwrite: a member that already analyzed a
                # plan on its own contributes it to the shared cache
                seen[key].update(A._plans)
                A._plans = seen[key]
            else:
                seen[key] = A._plans

    def solve(self, bs, **kw):
        self._share_plans()
        return [A.solve(b, **kw) for A, b in zip(self.tensors, bs)]

    def solve_with_info(self, bs, **kw):
        self._share_plans()
        return [A.solve_with_info(b, **kw)
                for A, b in zip(self.tensors, bs)]


# ---------------------------------------------------------------------------
# pipelined CG — beyond-paper (paper App. C names it as the roadmap item)
# ---------------------------------------------------------------------------

def _local_dots(r, u, w):
    return torch.stack([torch.sum(r * u), torch.sum(w * u),
                        torch.sum(r * r)])


def pipelined_cg(matvec: Callable, b: torch.Tensor, *,
                 M: Callable = lambda r: r, tol: float = 1e-6,
                 atol: float = 0.0, maxiter: int = 1000,
                 dots: Optional[Callable] = None,
                 dot: Optional[Callable] = None):
    """Ghysels–Vanroose pipelined CG: ONE reduction per iteration —
    ``dots(r, u, w)`` returns the global (<r,u>, <w,u>, <r,r>) from one
    fused length-3 reduction (the residual norm of the convergence test
    rides along) instead of separate all-reduces, and it can overlap the
    SpMV.  ``dot`` is the global inner product (the ‖b‖ of the target)."""
    dots = dots or _local_dots
    dot = dot or (lambda u, v: torch.sum(u * v))
    x = torch.zeros_like(b)
    r = b - matvec(x)
    u = M(r)
    w = matvec(u)
    gd = dots(r, u, w)
    bnorm = torch.sqrt(dot(b, b))
    target = torch.clamp_min(tol * bnorm, atol)
    z = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def cond(st):
        rr, k = st[-3], st[-1]
        return (k < maxiter) & (torch.sqrt(rr) > target)

    def body(st, act):
        (x, r, u, w, z, q, s, p, gamma, delta, gamma_prev, alpha_prev, rr,
         first, k) = st
        on = act != 0
        m_ = M(w)
        n_ = matvec(m_)
        beta = torch.where(first, zero, gamma / gamma_prev)
        alpha = torch.where(
            first, gamma / delta,
            gamma / (delta - beta * gamma / torch.where(alpha_prev == 0.0,
                                                        one, alpha_prev)))
        z = n_ + beta * z
        q = m_ + beta * q
        s = w + beta * s
        p = u + beta * p
        xn = x + alpha * p
        rn = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        gd = dots(rn, u, w)
        return (_solvers._keep(on, xn, x), _solvers._keep(on, rn, r), u, w,
                z, q, s, p, gd[0], gd[1], gamma, alpha,
                _solvers._keep(on, gd[2], rr), torch.zeros_like(first),
                k + act)

    st0 = (x, r, u, w, z, z, z, z, gd[0], gd[1], one, zero, gd[2],
           torch.ones((), dtype=torch.bool, device=b.device),
           torch.zeros((), dtype=torch.int64, device=b.device))
    st = _solvers._loop(cond, body, st0)
    x, rr, k = st[0], st[-3], st[-1]
    rn = torch.sqrt(rr)
    return x, _solvers.SolveInfo(k, rn, rn <= target)
