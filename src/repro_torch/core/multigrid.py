"""Multigrid preconditioners (port of ``repro.core.multigrid``) — one
level-hierarchy abstraction, two constructions.

* **Geometric** (``precond="mg"``, stencil operators): a matrix-free
  V-cycle — weighted-Jacobi smoothing, full-weighting restriction of the
  residual and of the coefficient field, piecewise-constant prolongation, a
  dense coarsest solve.  Every smoothing and residual matvec is the
  ``stencil5`` kernel (its plain version on a CPU tensor), on every level.

* **Algebraic** (``precond="amg"``, any COO pattern): smoothed-aggregation
  AMG in the plan engine.  The *analyze* half (:func:`amg_symbolic`, numpy,
  values-free, array-equal to the reference) aggregates the pattern
  (:func:`repro_torch.core.sparse.aggregate_pattern`), freezes the
  smoothed prolongator's pattern and packs the Galerkin product R·A·P into
  static gather / segment-sum programs
  (:func:`repro_torch.core.sparse.spgemm_program`); the coarsest level gets
  the direct solver's supernodal symbolic factorization (where the
  reference's ``supernodal="auto"`` would take the scalar scan for its few
  dozen unknowns).  :func:`amg_to_device` places
  the integer programs on the device once, as int32.  The *setup* half
  (:func:`amg_numeric`) evaluates the filtered-matrix weights, the
  prolongator smoothing and the triple product through those programs
  (gather + ``index_add_``) and refactorizes the coarsest level on the
  supernodal panel kernels; its solve is the ``sn_sweep`` kernel.
  ``PLAN_STATS["coarsen"]`` / ``["galerkin"]`` count the two halves.

On CUDA, ``index_add_`` accumulates with atomics: the Galerkin product, the
AMG transfers and the level matvecs add in a run-dependent order, so their
last bits (not the iteration count, see ``tests/test_torch_on_card.py``)
vary from run to run.  The CPU is deterministic.

Both constructions produce a tuple of :class:`Level` closures consumed by
the one :func:`v_cycle` routine.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.poisson import vc_coefficients
from ..kernels import stencil5 as _ks
from .sparse import aggregate_pattern, coo_matvec, spgemm_program

__all__ = [
    "Level", "v_cycle", "MultigridPreconditioner", "make_mg_preconditioner",
    "AMGLevelSymbolic", "AMGArtifacts", "amg_symbolic", "amg_to_device",
    "amg_numeric", "amg_hierarchy", "AMGPreconditioner",
]


# ---------------------------------------------------------------------------
# the shared hierarchy abstraction: Level closures + one V-cycle routine
# ---------------------------------------------------------------------------

class Level(NamedTuple):
    """One level of a multigrid hierarchy, as closures over its numeric
    state.  The coarsest level only needs ``coarse_solve``; every other
    level supplies the smoother / transfer quadruple.  ``post_smooth``
    defaults to ``smooth`` when None."""
    matvec: Callable            # x -> A_l @ x
    smooth: Callable            # (x, b) -> relaxed x (pre-smoother)
    restrict: Optional[Callable] = None    # r_l -> r_{l+1}
    prolong: Optional[Callable] = None     # e_{l+1} -> e_l
    coarse_solve: Optional[Callable] = None  # b -> A_l^{-1} b (last level)
    post_smooth: Optional[Callable] = None


def v_cycle(levels: Tuple[Level, ...], b: torch.Tensor, level: int = 0):
    """One V(pre, post)-cycle over ``levels`` (Python recursion over the
    static level count; nothing is read on the host)."""
    lv = levels[level]
    if lv.coarse_solve is not None:
        return lv.coarse_solve(b)
    x = lv.smooth(torch.zeros_like(b), b)
    r = b - lv.matvec(x)
    ec = v_cycle(levels, lv.restrict(r), level + 1)
    x = x + lv.prolong(ec)
    return (lv.post_smooth or lv.smooth)(x, b)


# ---------------------------------------------------------------------------
# geometric construction (structured 5-point stencil planes)
# ---------------------------------------------------------------------------

def _stencil_fn(v5: torch.Tensor) -> Callable:
    """x (ng, ng) -> the stencil of planes ``v5`` applied to x, through the
    ``stencil5`` kernel wrapper (looked up at call time)."""
    meta = _ks.Stencil5Meta(nx=int(v5.shape[1]), ny=int(v5.shape[2]))
    v5 = v5.contiguous()
    return lambda x: _ks.stencil5(meta, v5, x)


def _jacobi_weights(v5: torch.Tensor, omega: float) -> torch.Tensor:
    diag = v5[0]
    return torch.where(diag.abs() > 1e-30, omega / diag,
                       torch.zeros_like(diag))


def _smooth(apply: Callable, inv: torch.Tensor, x, b, iters: int = 2):
    """Weighted-Jacobi smoothing, ``inv`` = ω / diag of the planes."""
    for _ in range(iters):
        x = x + inv * (b - apply(x))
    return x


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2×2 restriction (cell-centred)."""
    ng = r.shape[0]
    return r.reshape(ng // 2, 2, ng // 2, 2).mean(dim=(1, 3))


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation (the transpose of the restriction up
    to its 1/4)."""
    return e.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _dense_stencil(v5: torch.Tensor) -> torch.Tensor:
    """The (nc, nc) dense matrix of planes ``v5`` (out-of-domain neighbours
    dropped, as the stencil reads them as zero)."""
    ng = v5.shape[1]
    nc = ng * ng
    idx = torch.arange(nc, device=v5.device).reshape(ng, ng)
    A = v5.new_zeros((nc, nc))
    A[idx, idx] = v5[0]
    A[idx[1:, :], idx[:-1, :]] = v5[1][1:, :]      # N: x[i-1, j]
    A[idx[:-1, :], idx[1:, :]] = v5[2][:-1, :]     # S: x[i+1, j]
    A[idx[:, 1:], idx[:, :-1]] = v5[3][:, 1:]      # W: x[i, j-1]
    A[idx[:, :-1], idx[:, 1:]] = v5[4][:, :-1]     # E: x[i, j+1]
    return A


def _build_levels(kappa: torch.Tensor, coarsest: int,
                  fine_planes: Optional[torch.Tensor] = None
                  ) -> Tuple[List[torch.Tensor], List[int]]:
    """Level hierarchy by 2×2-averaging κ (rediscretization coarsening).

    ``fine_planes``, when given, is the finest operator as it is (the
    smoother sees the assembled matrix); coarser levels come from
    ``vc_coefficients`` of the restricted κ."""
    levels: List[torch.Tensor] = []
    sizes: List[int] = []
    ng = kappa.shape[0]
    k = kappa

    def level_op(k, ng):
        if fine_planes is not None and not levels:
            return fine_planes
        return vc_coefficients(k).reshape(5, ng, ng)

    while ng >= coarsest and ng % 2 == 0:
        levels.append(level_op(k, ng))
        sizes.append(ng)
        k = _restrict(k)
        ng //= 2
    levels.append(level_op(k, ng))
    sizes.append(ng)
    return levels, sizes


class MultigridPreconditioner:
    """One V-cycle per application, built from a κ field (the paper's §4.4
    operator).

    Levels come from 2×2-averaging κ; the coarsest level is solved densely
    (LU factors made once per hierarchy).  Every level's operator is the
    same signed (5, n, n) planes the stencil kernel reads; the cycle runs
    through the shared :func:`v_cycle` routine."""

    def __init__(self, kappa: Optional[torch.Tensor] = None, *,
                 coarsest: int = 16, pre_smooth: int = 2,
                 post_smooth: int = 2, omega: float = 0.8,
                 _levels: Optional[List[torch.Tensor]] = None,
                 _sizes: Optional[List[int]] = None):
        self.pre, self.post, self.omega = pre_smooth, post_smooth, omega
        if _levels is None:
            _levels, _sizes = _build_levels(kappa, coarsest)
        self.levels, self.sizes = _levels, _sizes
        self.A_coarse = _dense_stencil(self.levels[-1])
        # the rediscretized coarse operator acts on a 2×-coarser grid: the
        # restricted residual takes a 4× factor (h² scaling of the stencil)
        self.scale = 4.0
        self._hier = self._build_hierarchy()

    @classmethod
    def from_planes(cls, v5: torch.Tensor, *, coarsest: int = 16,
                    **kw) -> "MultigridPreconditioner":
        """Build from assembled (5, ng, ng) stencil planes: a κ proxy from
        the centre plane (C = Σ couplings ≈ 4κ), the given planes as the
        finest operator, the restricted proxy rediscretized below.  The
        ``precond="mg"`` entry point of the plan."""
        if v5.dim() != 3 or v5.shape[0] != 5 or v5.shape[1] != v5.shape[2]:
            raise ValueError(
                f"from_planes expects (5, ng, ng), got {tuple(v5.shape)}")
        kappa_proxy = v5[0] / 4.0
        levels, sizes = _build_levels(kappa_proxy, coarsest, fine_planes=v5)
        return cls(_levels=levels, _sizes=sizes, **kw)

    def _build_hierarchy(self) -> Tuple[Level, ...]:
        out = []
        last = len(self.levels) - 1
        for lvl, v5 in enumerate(self.levels):
            apply = _stencil_fn(v5)
            if lvl == last:
                shape = (self.sizes[lvl],) * 2
                LU, piv, _ = torch.linalg.lu_factor_ex(self.A_coarse)
                out.append(Level(
                    matvec=apply, smooth=lambda x, b: x,
                    coarse_solve=lambda b, LU=LU, piv=piv, shape=shape:
                        torch.linalg.lu_solve(LU, piv, b.reshape(-1, 1))
                        .reshape(shape)))
            else:
                inv = _jacobi_weights(v5, self.omega)
                out.append(Level(
                    matvec=apply,
                    smooth=lambda x, b, a=apply, inv=inv, it=self.pre:
                        _smooth(a, inv, x, b, it),
                    restrict=lambda r: _restrict(r) * self.scale,
                    prolong=_prolong,
                    post_smooth=lambda x, b, a=apply, inv=inv, it=self.post:
                        _smooth(a, inv, x, b, it)))
        return tuple(out)

    def state(self) -> tuple:
        """Arrays-only state of the hierarchy: per-level stencil planes plus
        the dense coarse operator; :meth:`from_state` rebuilds the apply."""
        return (tuple(self.levels), self.A_coarse)

    @classmethod
    def from_state(cls, state: tuple, *, pre_smooth: int = 2,
                   post_smooth: int = 2,
                   omega: float = 0.8) -> "MultigridPreconditioner":
        """Rebuild the apply from a :meth:`state` tuple: closure assembly,
        the smoother weights and the coarse LU factors (64 unknowns at the
        default ``coarsest``)."""
        levels, A_coarse = state
        mg = cls.__new__(cls)
        mg.pre, mg.post, mg.omega = pre_smooth, post_smooth, omega
        mg.levels = list(levels)
        mg.sizes = [int(v5.shape[1]) for v5 in levels]
        mg.A_coarse = A_coarse
        mg.scale = 4.0
        mg._hier = mg._build_hierarchy()
        return mg

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        ng = self.sizes[0]
        return v_cycle(self._hier, r.reshape(ng, ng)).reshape(-1)


def make_mg_preconditioner(kappa: torch.Tensor, **kw) -> Callable:
    """Factory matching the ``core.precond`` interface."""
    mg = MultigridPreconditioner(kappa, **kw)
    return lambda r: mg(r)


# ---------------------------------------------------------------------------
# algebraic construction — smoothed-aggregation AMG in the plan engine
# ---------------------------------------------------------------------------

class AMGLevelSymbolic(NamedTuple):
    """Pattern-only artifacts of one AMG level (products of ``analyze``):
    numpy from :func:`amg_symbolic`, device tensors (int32 indices) after
    :func:`amg_to_device`.

    ``a2p`` scatters every A entry into its smoothed-prolongator slot
    (entry (i,j) → P slot (i, agg[j])); ``g1_*`` / ``g2_*`` are the two
    :func:`spgemm_program` halves of the Galerkin product Pᵀ·(A·P), so the
    numeric setup is two gathers + two segment sums per level."""
    n: int                       # fine size of this level
    n_c: int                     # coarse size (number of aggregates)
    arow: object                 # this level's pattern (level 0 = input A)
    acol: object
    diag_mask: object            # (nnz,) bool — diagonal entries of A_l
    agg: object                  # (n,) aggregate id per fine node
    p_row: object                # smoothed-prolongator pattern
    p_col: object
    a2p: object                  # (nnz,) A entry → P slot
    tent: object                 # (nnzP,) 1.0 on tentative slots (i, agg[i])
    g1_a: object                 # A·P product program
    g1_p: object
    g1_dst: object
    nnz_ap: int
    g2_p: object                 # Pᵀ·(A·P) product program
    g2_ap: object
    g2_dst: object
    nnz_c: int


class AMGArtifacts(NamedTuple):
    """Product of :func:`amg_symbolic` — the pattern half of the AMG plan,
    shared by every ``with_values`` refresh and the adjoint."""
    levels: Tuple[AMGLevelSymbolic, ...]
    coarse: object               # DirectArtifacts of the coarsest level
    n_coarse: int
    theta: float
    omega: float
    smooth_omega: float
    pre: int
    post: int
    stats: dict


def amg_symbolic(row, col, n: int, *, theta: float = 0.08,
                 omega: float = 2.0 / 3.0, smooth_omega: float = 2.0 / 3.0,
                 coarsest: int = 64, max_levels: int = 12,
                 pre_smooth: int = 1, post_smooth: int = 1) -> AMGArtifacts:
    """Analyze one sparsity pattern for smoothed-aggregation AMG (numpy).

    Values-free: aggregation, the smoothed prolongator's pattern and both
    Galerkin product programs depend only on the graph.  ``theta``
    (strength threshold) and ``omega`` (prolongator damping) are numeric
    knobs read by :func:`amg_numeric`.  The coarsest pattern goes through
    :func:`repro_torch.core.direct.symbolic_factor` with the supernodal
    program (unless the ``supernodal`` option is "off").  The level arrays
    are array-equal to the reference's; :func:`amg_to_device` places the
    result."""
    from . import direct as _direct
    from .dispatch import PLAN_STATS
    from ._device import to_numpy
    r = np.asarray(to_numpy(row), np.int64)
    c = np.asarray(to_numpy(col), np.int64)
    levels: List[AMGLevelSymbolic] = []
    n_l = n
    for _ in range(max_levels):
        if n_l <= coarsest:
            break
        agg, n_c = aggregate_pattern(r, c, n_l)
        if n_c >= n_l:                       # aggregation stalled — stop
            break
        # smoothed-prolongator pattern: P = (I − ω D⁻¹ Ā) T has slots
        # {(i, agg[j]) : (i,j) ∈ A} ∪ {(i, agg[i])}
        pkeys = np.unique(np.concatenate(
            [r * np.int64(n_c) + agg[c],
             np.arange(n_l, dtype=np.int64) * np.int64(n_c) + agg]))
        p_row = (pkeys // n_c).astype(np.int64)
        p_col = (pkeys % n_c).astype(np.int64)
        a2p = np.searchsorted(pkeys, r * np.int64(n_c) + agg[c])
        tent = (p_col == agg[p_row]).astype(np.float64)
        # Galerkin R·A·P as two static spgemm programs: AP = A·P, then
        # A_c = Pᵀ·AP (R = Pᵀ)
        g1_a, g1_p, g1_dst, ap_row, ap_col = spgemm_program(
            r, c, p_row, p_col, (n_l, n_c))
        g2_p, g2_ap, g2_dst, c_row, c_col = spgemm_program(
            p_col, p_row, ap_row, ap_col, (n_c, n_c))
        i32 = np.int32
        levels.append(AMGLevelSymbolic(
            n=n_l, n_c=n_c, arow=r.astype(i32), acol=c.astype(i32),
            diag_mask=r == c, agg=agg.astype(i32),
            p_row=p_row.astype(i32), p_col=p_col.astype(i32),
            a2p=a2p.astype(i32), tent=tent,
            g1_a=g1_a.astype(i32), g1_p=g1_p.astype(i32),
            g1_dst=g1_dst.astype(i32), nnz_ap=len(ap_row),
            g2_p=g2_p.astype(i32), g2_ap=g2_ap.astype(i32),
            g2_dst=g2_dst.astype(i32), nnz_c=len(c_row)))
        r, c, n_l = c_row, c_col, n_c
    # the coarsest level takes the supernodal panel program (its solve is
    # one sn_sweep launch per bucket and sweep): the ``supernodal`` option's
    # "auto" rule — the reference's choice — declines n < 512 for the scalar
    # scan, one Python-loop step of small launches per elimination level
    from . import options as _options
    mode = "off" if _options.current().supernodal == "off" else "on"
    coarse = _direct.symbolic_factor(r, c, n_l, supernodal=mode)
    PLAN_STATS["coarsen"] += 1
    stats = {"n_levels": len(levels) + 1, "n_coarse": n_l,
             "sizes": [lv.n for lv in levels] + [n_l]}
    return AMGArtifacts(levels=tuple(levels), coarse=coarse, n_coarse=n_l,
                        theta=theta, omega=omega, smooth_omega=smooth_omega,
                        pre=pre_smooth, post=post_smooth, stats=stats)


def amg_to_device(art: AMGArtifacts, device) -> AMGArtifacts:
    """The artifacts with every array on ``device`` — once per pattern, at
    analyze time: index programs int32, ``diag_mask`` bool, ``tent``
    float64, the coarsest level through ``direct.to_device``."""
    from . import direct as _direct
    device = torch.device(device)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    levels = tuple(lev._replace(**{
        f: on(getattr(lev, f)) for f in AMGLevelSymbolic._fields
        if isinstance(getattr(lev, f), np.ndarray)}) for lev in art.levels)
    return art._replace(levels=levels,
                        coarse=_direct.to_device(art.coarse, device))


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, n: int):
    return data.new_zeros(n).index_add_(0, seg, data)


def _amg_level_numeric(lev: AMGLevelSymbolic, aval: torch.Tensor,
                       theta: float, omega: float):
    """One level of the numeric setup: filtered-matrix weights, prolongator
    smoothing, the Galerkin product through the index programs.  Returns
    ``(dinv, p_val, c_val)``."""
    zero = torch.zeros((), dtype=aval.dtype, device=aval.device)
    d = _segment_sum(torch.where(lev.diag_mask, aval, zero), lev.arow, lev.n)
    # strength filtering: keep |a_ij| ≥ θ √|a_ii a_jj|, lump the dropped mass
    # into the diagonal (Vaněk's filtered matrix Ā) — numeric, so the SAME
    # pattern program serves every values refresh
    strong = aval.abs() >= theta * torch.sqrt(
        (d[lev.arow] * d[lev.acol]).abs() + 1e-300)
    keep = lev.diag_mask | strong
    a_f = torch.where(keep, aval, zero)
    lump = _segment_sum(torch.where(keep, zero, aval), lev.arow, lev.n)
    d_f = d - lump
    dinv_f = torch.where(d_f.abs() > 1e-30, 1.0 / d_f, zero)
    # P = (I − ω D̄⁻¹ Ā) T: scatter Ā through a2p, subtract the lumped mass
    # at the tentative slot (Ā's diagonal adjustment), add T
    tent = lev.tent.to(aval.dtype)
    p_sum = _segment_sum(a_f, lev.a2p, lev.p_row.shape[0])
    p_sum = p_sum - tent * lump[lev.p_row]
    p_val = tent - omega * dinv_f[lev.p_row] * p_sum
    # Galerkin A_c = Pᵀ (A P) — two gathers + two segment sums, unfiltered A
    ap = _segment_sum(aval[lev.g1_a] * p_val[lev.g1_p], lev.g1_dst,
                      lev.nnz_ap)
    c_val = _segment_sum(p_val[lev.g2_p] * ap[lev.g2_ap], lev.g2_dst,
                         lev.nnz_c)
    dinv = torch.where(d.abs() > 1e-30, 1.0 / d, zero)
    return dinv, p_val, c_val


def amg_numeric(art: AMGArtifacts, val: torch.Tensor):
    """The numeric half of the AMG plan (the ``setup`` stage): per level
    the smoothing weights, prolongator values and Galerkin coarse values,
    then the coarsest level's numeric LDLᵀ/LU (``art`` from
    :func:`amg_to_device`, on ``val``'s device).  Memoized per values
    tensor by ``SolverPlan.setup``."""
    from . import direct as _direct
    from .dispatch import PLAN_STATS
    PLAN_STATS["galerkin"] += 1
    state = []
    with torch.no_grad():
        aval = val.detach()
        for lev in art.levels:
            dinv, p_val, c_val = _amg_level_numeric(lev, aval, art.theta,
                                                    art.omega)
            state.append((aval, dinv, p_val))
            aval = c_val
        C = _direct.numeric_factor(art.coarse, aval)
    return tuple(state), C


def amg_hierarchy(art: AMGArtifacts, state) -> Tuple[Level, ...]:
    """The :class:`Level` tuple of :func:`v_cycle` from the symbolic
    artifacts + numeric state: COO level matvecs, damped-Jacobi smoothing,
    restrict = Pᵀ r and prolong = P e through the prolongator's pattern,
    the coarsest level on the factored solve."""
    from . import direct as _direct
    per_level, C = state
    levels = []
    for lev, (aval, dinv, p_val) in zip(art.levels, per_level):
        def mv(x, aval=aval, lev=lev):
            return coo_matvec(aval, lev.arow, lev.acol, x, lev.n)

        def make_smooth(mv, dinv, it, om=art.smooth_omega):
            def smooth(x, b):
                for _ in range(it):
                    x = x + om * dinv * (b - mv(x))
                return x
            return smooth

        levels.append(Level(
            matvec=mv,
            smooth=make_smooth(mv, dinv, art.pre),
            restrict=lambda r, lev=lev, p_val=p_val: _segment_sum(
                p_val * r[lev.p_row], lev.p_col, lev.n_c),
            prolong=lambda e, lev=lev, p_val=p_val: _segment_sum(
                p_val * e[lev.p_col], lev.p_row, lev.n),
            post_smooth=make_smooth(mv, dinv, art.post)))
    levels.append(Level(
        matvec=lambda x: x,
        smooth=lambda x, b: x,
        coarse_solve=lambda b: _direct.factored_solve(art.coarse, C, b)))
    return tuple(levels)


class AMGPreconditioner:
    """Apply closure for ``precond="amg"``: one V-cycle per application
    over the plan's frozen hierarchy, built by ``PreconditionerPlan``
    from (device artifacts, numeric state)."""

    def __init__(self, art: AMGArtifacts, state):
        self.art = art
        self.levels = amg_hierarchy(art, state)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return v_cycle(self.levels, r)
