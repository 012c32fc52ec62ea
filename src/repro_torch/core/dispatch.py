"""Backend registry + plan-cached dispatch (port of ``repro.core.dispatch``).

Every solve goes through the reference's three-stage split::

    plan  = get_plan(A, cfg)        # ❶ analyze(pattern)  — eager, cached
    state = plan.setup(A)           # ❷ setup(values)     — memoized per values
    x, info = plan.solve(A, b, x0)  # ❸ solve(b)          — Krylov / dense LU

❶ runs once per (pattern, backend/method/precond): it freezes the matvec
kernel (:class:`KernelPlan`: block-ELL, stencil or COO) and the
preconditioner's pattern stage.  Plans are cached on the ``SparseTensor``
(shared by ``with_values``).  ❷ consumes the values: Jacobi diagonal, dense
materialization, and — new in the port — the block-ELL tile assembly, done
ONCE per values tensor instead of on every matvec.  The setup memo keys on
the identity of the values tensor AND its ``_version`` (torch values can be
changed in place).  The adjoint layer solves Aᵀλ = g on ``plan.transpose()``:
the same plan for symmetric patterns, a layout-sharing sibling for the
block-ELL and stencil kernels, a once-analyzed transposed sibling otherwise.

Backends: ``dense`` (torch.linalg), ``direct`` (sparse LDLᵀ/LU on the
supernodal panel kernels, :mod:`repro_torch.core.direct`), ``jnp`` (COO,
or BELL where fill allows on CUDA), ``pallas`` (explicit block-ELL) and
``stencil``.  Batched values or right-hand sides raise until slice 5.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import direct as _direct
from . import options as _options
from . import precond as _precond
from . import solvers as _solvers
from ._device import to_numpy
from .sparse import (SparseTensor, bell_to_device, build_bell, coo_matvec,
                     has_full_diagonal)

DEFAULT_MAXITER = 2000

# observable analyze/setup/cache counters (reset with ``reset_plan_stats``);
# same names and meanings as the reference's
PLAN_STATS: Dict[str, int] = {
    "analyze": 0,          # SolverPlan constructions (pattern analyses)
    "setup": 0,            # values-dependent setups actually executed
    "setup_reuse": 0,      # setups served from the per-values memo
    "factorize": 0,        # numeric factorizations run by the direct backend
    "cache_hit": 0,        # plan served from a SparseTensor's plan cache
    "cache_miss": 0,       # plan analyzed fresh
    "transpose_shared": 0,  # adjoint reused the forward plan (or its layouts)
    "t_partition": 0,      # distributed Aᵀ partitions built (once per plan)
    "coarsen": 0,          # AMG pattern coarsenings (symbolic, once/pattern)
    "galerkin": 0,         # AMG numeric Galerkin products (once/values array)
    "kernel_plan": 0,      # BELL conversions run by the analyze-time kernel plan
    "evictions": 0,        # plans dropped by the bounded LRU plan cache
    "jac_color": 0,        # Jacobian pattern colorings (once per SparseNewton)
    "jac_assemble": 0,     # numeric Jacobian assemblies (jvp probe sweeps)
}


def reset_plan_stats() -> None:
    """Zero every ``PLAN_STATS`` counter."""
    for k in PLAN_STATS:
        PLAN_STATS[k] = 0


class PlanCache(collections.OrderedDict):
    """Pattern-keyed plan cache: LRU entry cap + optional byte budget (both
    live reads of the options unless pinned by the constructor)."""

    def __init__(self, cap: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        super().__init__()
        self._cap = cap
        self._max_bytes = max_bytes
        self._sizes: Dict[Any, int] = {}
        self.total_bytes = 0

    @property
    def cap(self) -> int:
        return self._cap if self._cap is not None \
            else _options.current().plan_cache_cap

    @property
    def max_bytes(self) -> Optional[int]:
        return self._max_bytes if self._max_bytes is not None \
            else _options.current().plan_cache_bytes

    @staticmethod
    def _nbytes_of(value) -> int:
        nbytes = getattr(value, "nbytes", None)
        return int(nbytes()) if callable(nbytes) else 0

    def get(self, key, default=None):
        if key in self:
            self.move_to_end(key)
            return super().get(key)
        return default

    def _evict_oldest(self) -> None:
        old, _ = self.popitem(last=False)
        self.total_bytes -= self._sizes.pop(old, 0)
        PLAN_STATS["evictions"] += 1

    def __setitem__(self, key, value):
        if key in self:            # replace = delete + fresh LRU insert
            super().__delitem__(key)
            self.total_bytes -= self._sizes.pop(key, 0)
        nb = self._nbytes_of(value)
        budget = self.max_bytes
        # keep at least the incoming entry resident
        while self and (len(self) >= self.cap or
                        (budget is not None and
                         self.total_bytes + nb > budget)):
            self._evict_oldest()
        super().__setitem__(key, value)
        self._sizes[key] = nb
        self.total_bytes += nb

    def __delitem__(self, key):
        super().__delitem__(key)
        self.total_bytes -= self._sizes.pop(key, 0)

    def clear(self):
        super().clear()
        self._sizes.clear()
        self.total_bytes = 0


@dataclasses.dataclass
class KernelPlan:
    """Analyze-time matvec kernel choice — a frozen plan artifact.

    ``choice``: "bell" | "stencil" | "coo"; ``reason`` records why.
    ``interpret`` is True where the plain versions run (the pattern lies on
    the CPU) — the port's reading of the reference's interpret-mode flag.
    ``bell``/``t_bell`` are the block-ELL plans of A and Aᵀ
    (``core.sparse.BellLayout``: meta, block_cols and perm on the host, the
    sliced-ELL layout the kernel reads on the device; ``t_bell is bell`` for
    symmetric patterns)."""
    choice: str
    reason: str
    interpret: bool
    bell: Optional[tuple] = None
    t_bell: Optional[tuple] = None


def _build_kernel_plan(pattern, prefer: str) -> KernelPlan:
    """Freeze the matvec kernel for one analyzed pattern.

    ``prefer``: "stencil" (stencil backend), "bell" (pallas backend —
    explicit opt-in, adopted on the CPU too), "auto" (jnp backend — BELL
    only on CUDA and where the fill clears ``bell_min_fill``), "coo"."""
    from ..kernels.solve_step import default_interpret
    device = pattern.row.device
    interp = default_interpret(device)
    if prefer == "stencil":
        if pattern.stencil is not None:
            return KernelPlan("stencil", "stencil layout present", interp)
        prefer = "auto"
    if prefer == "coo":
        return KernelPlan("coo", "backend prefers segment-sum", interp)
    if prefer == "auto" and interp:
        # the plain versions run on the CPU — segment-sum wins there
        return KernelPlan("coo", "interpret-mode platform", interp)
    bell = pattern.bell                     # construction-time layout, if any
    if bell is None:
        bell = build_bell(pattern.row, pattern.col, pattern.shape)
        PLAN_STATS["kernel_plan"] += 1
    meta = bell[0]
    # the reference's gate: below the fill floor its padded tiles cost more
    # than they save, so the plan records a segment-sum fallback (2-D
    # Poisson drops below the default 1/64 from ng≈100 up: 0.0129 at
    # ng=100, 0.0098 at ng=1024).  Kept for plan parity, although the
    # sliced-ELL kernel here reads only the nonzeros.
    min_fill = _options.current().bell_min_fill
    if prefer != "bell" and meta.fill < min_fill:
        return KernelPlan(
            "coo", f"bell fill {meta.fill:.4f} < {min_fill:.4f}", interp)
    bell = bell_to_device(bell, device)
    n, m = pattern.shape
    if n == m and pattern.props.get("symmetric", False):
        t_bell = bell                       # Aᵀ shares A's layout outright
    else:
        t_bell = bell_to_device(
            build_bell(pattern.col, pattern.row, (m, n)), device)
        PLAN_STATS["kernel_plan"] += 1
    return KernelPlan("bell", f"fill={meta.fill:.4f}", interp, bell, t_bell)


def _fuse_enabled(kp: Optional[KernelPlan]) -> bool:
    """Fused CG/BiCGStab step kernels: "auto" enables them on CUDA and keeps
    the plain loops for CPU tensors; "on"/"off" force either path.  Read at
    solve time, not frozen into the plan."""
    mode = _options.current().fused_step
    if mode == "on":
        return True
    if mode == "off" or kp is None:
        return False
    return not kp.interpret


def _plan_matvec(plan: "SolverPlan", kp: KernelPlan, val,
                 packed=None) -> Callable:
    """Single-instance matvec closure through the kernel plan's choice;
    ``packed`` is the sliced-ELL value array already assembled from
    ``val``."""
    n = plan.shape[0]
    if kp.choice == "stencil" and plan.stencil is not None:
        from ..kernels import ops as kops
        return lambda x: kops.stencil5_matvec(plan.stencil, val, x)
    if kp.choice == "bell" and kp.bell is not None:
        from ..kernels import ops as kops
        return lambda x: kops.bell_matvec(kp.bell, val, x, n,
                                          t_bell=kp.t_bell, packed=packed)
    row, col = plan.row, plan.col
    return lambda x: coo_matvec(val, row, col, x, n)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hashable solver configuration."""
    backend: str = "auto"
    method: str = "auto"
    tol: float = 1e-6
    atol: float = 0.0
    maxiter: int = DEFAULT_MAXITER
    precond: str = "jacobi"
    restart: int = 32            # gmres

    def resolved(self, A: SparseTensor) -> "SolverConfig":
        b, m = select_backend(A, self.backend, self.method)
        return dataclasses.replace(self, backend=b, method=m)

    def plan_key(self) -> Tuple[str, str, str]:
        """Plan-cache key: only the fields the analyze stage depends on."""
        return (self.backend, self.method, self.precond)


# ---------------------------------------------------------------------------
# kernel (matvec) selection — shared by backends and the public ``matvec``
# ---------------------------------------------------------------------------

def _on_cuda(A) -> bool:
    return A.row.device.type == "cuda"


def _select_kernel(A: SparseTensor, backend: Optional[str] = None) -> str:
    if backend in (None, "auto"):
        if A.stencil is not None:
            return "stencil"
        if A.bell is not None and _on_cuda(A):
            return "bell"
        return "coo"
    if backend == "stencil" and A.stencil is not None:
        return "stencil"
    if backend == "pallas" and A.bell is not None:
        return "bell"
    return "coo"


def _kernel_fn(A, kernel: str) -> Callable:
    """Single-instance SpMV as a function of (val, x)."""
    if kernel == "stencil" and A.stencil is not None:
        from ..kernels import ops as kops
        return lambda v, x: kops.stencil5_matvec(A.stencil, v, x)
    if kernel == "bell" and A.bell is not None:
        from ..kernels import ops as kops
        bell, n = A.bell, A.shape[0]
        return lambda v, x: kops.bell_matvec(bell, v, x, n)
    row, col, n = A.row, A.col, A.shape[0]
    return lambda v, x: coo_matvec(v, row, col, x, n)


def matvec(A: SparseTensor, x, backend: Optional[str] = None):
    """A @ x (differentiable).  Batched values/rhs run through the COO
    product; batched kernel layouts come with slice 5."""
    kernel = _select_kernel(A, backend)
    batched = bool(A.batch_shape) or x.dim() > 1
    if not batched:
        return _kernel_fn(A, kernel)(A.val, x)
    if kernel == "coo":
        return coo_matvec(A.val, A.row, A.col, x, A.shape[0])
    raise NotImplementedError(
        "batched matvec through the stencil/block-ELL kernels comes with "
        "slice 5 of the PyTorch port (batching and serving)")


# ---------------------------------------------------------------------------
# backend classes — each exposes the analyze/setup/solve stages
# ---------------------------------------------------------------------------

class Backend:
    """A solver backend: ``analyze(cfg, pattern)`` (eager, values-free),
    ``setup(plan, A)`` (values), ``solve(plan, state, A, b, x0, cfg)``."""
    name: str = "abstract"
    methods: Tuple[str, ...] = ()
    cache_setup = False         # True: memoize setup() per values tensor

    def applicable(self, A: SparseTensor) -> bool:
        return True

    def transpose_plan(self, plan: "SolverPlan") -> Optional["SolverPlan"]:
        """Optionally build the adjoint plan from this plan's artifacts;
        ``None`` falls back to analyzing a transposed sibling."""
        return None

    def default_method(self, A: SparseTensor) -> str:
        sym = A.props.get("symmetric", False)
        spd = A.props.get("spd_hint", False)
        return "cg" if (spd or sym) else "bicgstab"

    def analyze(self, cfg: SolverConfig, pattern) -> dict:
        return {}

    def setup(self, plan: "SolverPlan", A: SparseTensor):
        return None

    def solve(self, plan: "SolverPlan", state, A: SparseTensor, b, x0,
              cfg: SolverConfig):
        raise NotImplementedError


class DenseBackend(Backend):
    name = "dense"
    methods = ("lu", "cholesky")
    cache_setup = True

    def applicable(self, A):
        return A.shape[0] == A.shape[1]

    def default_method(self, A):
        return "cholesky" if A.props.get("spd_hint", False) else "lu"

    def setup(self, plan, A):
        return A.todense()

    def solve(self, plan, dense, A, b, x0, cfg):
        return _solvers.dense_solve(dense, b, cfg.method)


class DirectBackend(Backend):
    """Sparse direct LDLᵀ/LU with a cached symbolic factorization — the
    cuDSS-analogue path.  ``analyze`` runs the numpy symbolic stage of
    :mod:`repro_torch.core.direct` once per pattern and places its
    artifacts on the pattern's device; ``setup`` is the numeric
    refactorization on the supernodal panel kernels (memoized per values
    tensor via ``cache_setup``); ``solve`` is two triangular sweeps plus a
    residual check.  The adjoint reuses the forward factors: symmetric
    patterns share the plan outright, non-symmetric ones get a
    shared-artifact transpose plan whose solve runs the mirrored (Uᵀ, Lᵀ)
    sweeps — zero refactorizations either way."""
    name = "direct"
    methods = ("ldlt", "lu")
    cache_setup = True

    def applicable(self, A):
        n, m = A.shape
        if n != m:
            return False
        if "struct_full_diag" not in A.props:
            A.props["struct_full_diag"] = has_full_diagonal(A.row, A.col, n)
        return A.props["struct_full_diag"]   # no pivoting: pivots must exist

    def default_method(self, A):
        return "ldlt" if A.props.get("symmetric", False) else "lu"

    def analyze(self, cfg, pattern):
        if cfg.method == "ldlt" and not pattern.props.get("symmetric", False):
            raise ValueError(
                "method='ldlt' needs symmetric values; use method='lu'")
        art = _direct.symbolic_factor(
            to_numpy(pattern.row), to_numpy(pattern.col), pattern.shape[0],
            # indefinite-hinted systems get static Bunch–Kaufman 2x2 pivot
            # blocks (chosen at analyze time) instead of relying on the
            # zero-pivot perturbation stopgap at factor time
            pivot_blocks=("auto" if pattern.props.get("indefinite_hint")
                          else None))
        return {"direct": _direct.to_device(art, pattern.device),
                "transposed": False}

    def setup(self, plan, A):
        PLAN_STATS["factorize"] += 1
        return _direct.numeric_factor(plan.artifacts["direct"], A.val)

    def solve(self, plan, C, A, b, x0, cfg):
        x = _direct.factored_solve(plan.artifacts["direct"], C, b,
                                   transposed=plan.artifacts["transposed"])
        r = b - coo_matvec(A.val, A.row, A.col, x, A.shape[0])
        rn = torch.linalg.norm(r)
        target = torch.clamp_min(cfg.tol * torch.linalg.norm(b), cfg.atol)
        return x, _solvers.SolveInfo(
            iters=torch.ones((), dtype=torch.int64, device=b.device),
            resnorm=rn, converged=rn <= target)

    def transpose_plan(self, plan):
        """Adjoint plan sharing THIS plan's symbolic artifacts and numeric
        factors (the setup memo is shared): solving Aᵀλ = g runs the Uᵀ/Lᵀ
        sweeps on the forward factorization."""
        tp = SolverPlan.__new__(SolverPlan)
        tp.cfg = plan.cfg
        tp.backend = plan.backend
        tp.row, tp.col = plan.col, plan.row
        tp.shape = (plan.shape[1], plan.shape[0])
        tp.props = dict(plan.props)
        tp.bell, tp.stencil = None, None
        tp._cache = {tp.cfg.plan_key(): tp}
        tp._tplan = plan
        tp._setup_memo = plan._setup_memo       # forward factors reused
        tp.artifacts = dict(plan.artifacts,
                            transposed=not plan.artifacts["transposed"])
        return tp


class IterativeBackend(Backend):
    """Shared machinery of the Krylov backends: kernel matvec + Jacobi.

    ``setup`` returns ``(val, pstate, dinv, packed)``: the (possibly
    transpose-remapped) values, the preconditioner state, the diagonal
    inverse for the fused kernels, and the block-ELL plan's sliced-ELL value
    array, assembled once per values tensor (None for the COO and stencil
    kernels; no dense tiles are built)."""
    kernel = "auto"             # kernel-plan preference (see _build_kernel_plan)
    methods = ("cg", "bicgstab", "gmres", "block_cg")
    cache_setup = True

    def analyze(self, cfg, pattern):
        if cfg.method == "block_cg":
            raise NotImplementedError(
                "method='block_cg' is not ported yet (slice 5 of the "
                "PyTorch port: batching and serving)")
        return {
            "kernel": _build_kernel_plan(pattern, self.kernel),
            "precond": _precond.PreconditionerPlan(
                cfg.precond, pattern.row, pattern.col, pattern.shape,
                stencil=pattern.stencil)}

    def _matvec_from_val(self, plan, val, packed=None) -> Callable:
        kp = plan.artifacts.get("kernel")
        if kp is not None:
            return _plan_matvec(plan, kp, val, packed)
        fn = _kernel_fn(plan, self.kernel)
        return lambda x: fn(val, x)

    def setup(self, plan, A):
        kp = plan.artifacts.get("kernel")
        packed = None
        if kp is not None and kp.choice == "bell" and kp.bell is not None:
            from ..kernels import ops as kops
            packed = kops.sell_assemble(kp.bell.sell, A.val)
        mv = self._matvec_from_val(plan, A.val, packed)
        pre = plan.artifacts["precond"]
        pstate = pre.refresh_state(A, mv)
        dinv = pre.fused_diag(A)
        return A.val, pstate, dinv, packed

    def solve(self, plan, state, A, b, x0, cfg):
        val, pstate, dinv, packed = state
        # rebuild from the STATE's values, not A.val: transpose plans remap
        # the forward values in setup (_StencilTransposeBackend)
        mv = self._matvec_from_val(plan, val, packed)
        kp = plan.artifacts.get("kernel")
        fuse = _fuse_enabled(kp)
        M = plan.artifacts["precond"].make_apply(pstate, mv, fused=fuse)
        if cfg.method == "cg":
            if fuse:
                return _solvers.cg_fused(mv, b, x0, dinv=dinv, M=M,
                                         tol=cfg.tol, atol=cfg.atol,
                                         maxiter=cfg.maxiter)
            return _solvers.cg(mv, b, x0, M=M, tol=cfg.tol, atol=cfg.atol,
                               maxiter=cfg.maxiter)
        if cfg.method == "bicgstab":
            if fuse:
                return _solvers.bicgstab_fused(mv, b, x0, dinv=dinv, M=M,
                                               tol=cfg.tol, atol=cfg.atol,
                                               maxiter=cfg.maxiter)
            return _solvers.bicgstab(mv, b, x0, M=M, tol=cfg.tol,
                                     atol=cfg.atol, maxiter=cfg.maxiter)
        if cfg.method == "gmres":
            return _solvers.gmres(mv, b, x0, M=M, tol=cfg.tol, atol=cfg.atol,
                                  restart=cfg.restart,
                                  maxiter=max(cfg.maxiter // cfg.restart, 1))
        raise ValueError(
            f"unknown method {cfg.method!r} for backend {cfg.backend!r}")

    def transpose_plan(self, plan):
        """Adjoint plan sharing THIS plan's kernel layouts: Aᵀ's block-ELL
        slot table was built in the same analyze pass (``t_bell``), so the
        backward matvec hits the same kernel with zero re-analysis.  Only for
        plans that adopted BELL."""
        kp = plan.artifacts.get("kernel")
        if kp is None or kp.choice != "bell" or kp.t_bell is None:
            return None
        n, m = plan.shape
        if n != m or plan.cfg.precond == "mg":
            return None
        tp = SolverPlan.__new__(SolverPlan)
        tp.cfg = plan.cfg
        tp.backend = plan.backend
        tp.row, tp.col = plan.col, plan.row
        tp.shape = (m, n)
        tp.props = dict(plan.props)
        tp.bell, tp.stencil = kp.t_bell, None
        tp._cache = {tp.cfg.plan_key(): tp}
        tp._tplan = plan
        tp._setup_memo = {}      # Aᵀ preconditioner state differs
        tp.artifacts = {
            "kernel": dataclasses.replace(kp, bell=kp.t_bell, t_bell=kp.bell),
            "precond": _precond.PreconditionerPlan(
                plan.cfg.precond, tp.row, tp.col, tp.shape, stencil=None)}
        return tp


class JnpBackend(IterativeBackend):
    """General COO backend (the reference's name).  Its kernel plan is
    "auto": segment-sum for CPU tensors and for low-fill patterns, block-ELL
    on CUDA where the fill clears ``bell_min_fill``."""
    name = "jnp"
    kernel = "auto"


class PallasBackend(IterativeBackend):
    """Explicit block-ELL opt-in (the reference's name): the kernel plan
    adopts BELL regardless of fill or device."""
    name = "pallas"
    kernel = "bell"


class StencilBackend(IterativeBackend):
    name = "stencil"
    kernel = "stencil"
    methods = ("cg", "bicgstab")

    def applicable(self, A):
        return A.stencil is not None

    def transpose_plan(self, plan):
        """Adjoint plan that KEEPS the stencil kernel: Aᵀ of a 5-point
        stencil operator is the same operator with its coupling planes
        exchanged and shifted (``ops.stencil_transpose_planes``, the planes
        the kernel's own backward uses); the transpose plan's setup builds
        them from the FORWARD values."""
        meta = plan.stencil
        if meta is None or meta.nx != meta.ny:
            return None
        ng = meta.nx
        if plan.shape != (ng * ng, ng * ng):
            return None
        tp = SolverPlan.__new__(SolverPlan)
        tp.cfg = plan.cfg
        tp.backend = _STENCIL_T
        tp.row, tp.col = plan.row, plan.col
        tp.shape = plan.shape
        tp.props = dict(plan.props)
        tp.bell, tp.stencil = None, plan.stencil
        tp._cache = {tp.cfg.plan_key(): tp}
        tp._tplan = plan
        tp._setup_memo = {}        # Aᵀ values differ from the forward values
        tp.artifacts = {
            "kernel": _build_kernel_plan(tp, "stencil"),
            "precond": _precond.PreconditionerPlan(
                plan.cfg.precond, plan.row, plan.col, plan.shape,
                stencil=plan.stencil)}
        return tp


class _StencilTransposeBackend(StencilBackend):
    """Backend of the stencil transpose plan: setup first turns the forward
    values into transposed planes."""
    name = "stencil"            # reported name matches the forward backend

    def setup(self, plan, A):
        from ..kernels import ops as kops
        meta = plan.stencil
        v5 = A.val.reshape(5, meta.nx, meta.ny)
        return super().setup(
            plan, plan.matrix(kops.stencil_transpose_planes(v5).reshape(-1)))


_STENCIL_T = _StencilTransposeBackend()

BACKENDS: Dict[str, Backend] = {
    b.name: b for b in (DenseBackend(), DirectBackend(), JnpBackend(),
                        PallasBackend(), StencilBackend())}


def select_backend(A: SparseTensor, backend: str, method: str):
    """Size- and device-aware auto-dispatch (the reference's rules, with its
    TPU test read as "the tensor lies on a CUDA device"): explicit overrides;
    stencil layouts; dense below ``dense_budget``; sparse-direct for
    ill-conditioned hints and mid-size systems;
    block-ELL where a construction-time layout exists on CUDA; COO above."""
    n = A.shape[0]
    opts = _options.current()
    if backend == "auto":
        if A.stencil is not None:
            backend = "stencil"
        elif n <= opts.dense_budget and not A.batch_shape and \
                BACKENDS["dense"].applicable(A):
            backend = "dense"
        elif A.props.get("illcond_hint", False) \
                and n <= 4 * opts.direct_budget \
                and BACKENDS["direct"].applicable(A):
            backend = "direct"
        elif A.bell is not None and _on_cuda(A):
            backend = "pallas"
        elif n <= opts.direct_budget and BACKENDS["direct"].applicable(A):
            backend = "direct"
        else:
            backend = "jnp"
    if method == "auto":
        method = BACKENDS[backend].default_method(A) \
            if backend in BACKENDS else "cg"
    return backend, method


def make_config(A: SparseTensor, *, backend=None, method=None, tol=1e-6,
                atol=0.0, maxiter=None, precond="jacobi",
                restart=32) -> SolverConfig:
    cfg = SolverConfig(backend=backend or "auto", method=method or "auto",
                       tol=tol, atol=atol,
                       maxiter=maxiter or DEFAULT_MAXITER,
                       precond=precond, restart=restart)
    return cfg.resolved(A)


# ---------------------------------------------------------------------------
# SolverPlan — the analyze(pattern) product
# ---------------------------------------------------------------------------

class SolverPlan:
    """Reusable symbolic setup for one (sparsity pattern, SolverConfig).

    Holds only pattern-level state — indices, shape, properties, kernel
    layouts and the backend's analyze artifacts — so one plan serves every
    ``with_values`` refresh and the adjoint solve of the backward pass."""

    def __init__(self, cfg: SolverConfig, A: SparseTensor,
                 cache: Optional[dict] = None):
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {cfg.backend!r}")
        self.cfg = cfg
        self.backend = BACKENDS[cfg.backend]
        if self.backend.methods and cfg.method not in self.backend.methods:
            raise ValueError(
                f"method {cfg.method!r} not supported by backend "
                f"{cfg.backend!r} (supported: {self.backend.methods})")
        self.row, self.col = A.row, A.col
        self.shape = tuple(A.shape)
        self.props = dict(A.props)
        self.bell = A.bell
        self.stencil = A.stencil
        self._cache = cache if cache is not None else {cfg.plan_key(): self}
        self._tplan: Optional["SolverPlan"] = None
        self._setup_memo: dict = {}
        PLAN_STATS["analyze"] += 1
        self.artifacts = self.backend.analyze(cfg, self)

    @property
    def device(self) -> torch.device:
        return self.row.device

    # -- stage ❷: values-dependent setup -------------------------------------
    def _memo_lookup(self, slot: str, key: torch.Tensor):
        """Memo hit: the SAME values tensor object at the same version."""
        hit = self._setup_memo.get(slot)
        if hit is not None and hit[0]() is key and hit[1] == key._version:
            PLAN_STATS["setup_reuse"] += 1
            return hit[2]
        return None

    def _memo_store(self, slot: str, key: torch.Tensor, state) -> None:
        memo = self._setup_memo
        box = {}

        def _drop(_, m=memo, b=box, s=slot):
            # evict ONLY our own entry: a dead values tensor must not pop a
            # successor that already replaced it
            if m.get(s) is b.get("entry"):
                m.pop(s, None)

        box["entry"] = (weakref.ref(key, _drop), key._version, state)
        memo[slot] = box["entry"]

    def setup(self, A: SparseTensor):
        """Run (or reuse) the backend's values-dependent setup, memoized per
        values tensor (identity + in-place version) for ``cache_setup``
        backends — a tolerance sweep and the adjoint backward reuse ONE
        setup."""
        if self.backend.cache_setup:
            hit = self._memo_lookup("state", A.val)
            if hit is not None:
                return hit
        PLAN_STATS["setup"] += 1
        with torch.no_grad():
            state = self.backend.setup(self, A)
        if self.backend.cache_setup:
            self._memo_store("state", A.val, state)
        return state

    # -- stage ❸: solve ------------------------------------------------------
    def solve(self, A: SparseTensor, b, x0=None,
              cfg: Optional[SolverConfig] = None):
        """One un-differentiated solve.  ``cfg`` overrides the solve-loop
        knobs (tol/atol/maxiter) without re-analyzing."""
        if A.batch_shape or b.dim() != 1:
            raise NotImplementedError(
                "batched values or right-hand sides come with slice 5 of the "
                "PyTorch port (batching and serving)")
        cfg = cfg if cfg is not None else self.cfg
        state = self.setup(A)
        with torch.no_grad():
            return self.backend.solve(self, state, A, b, x0, cfg)

    # -- pattern helpers -----------------------------------------------------
    def nbytes(self) -> int:
        """Estimated resident bytes of this plan's analyze artifacts (slot
        tables, maps) plus the pattern arrays they reference."""
        seen = set()
        total = 0

        def visit(obj):
            nonlocal total
            if obj is None or isinstance(obj, (int, float, bool, str, bytes,
                                               complex)):
                return
            if id(obj) in seen:
                return
            seen.add(id(obj))
            nb = getattr(obj, "nbytes", None)
            if isinstance(nb, int):
                total += nb
                return
            if isinstance(obj, dict):
                for v in obj.values():
                    visit(v)
            elif isinstance(obj, (tuple, list)):
                for v in obj:
                    visit(v)
            elif dataclasses.is_dataclass(obj):
                for f in dataclasses.fields(obj):
                    visit(getattr(obj, f.name))
            elif hasattr(obj, "__dict__"):
                for v in vars(obj).values():
                    visit(v)

        visit(self.artifacts)
        visit(self.bell)
        visit((self.row, self.col))
        return total

    def matrix(self, val) -> SparseTensor:
        """SparseTensor view of this plan's pattern carrying ``val`` —
        shares the plan cache, so nested solves hit this plan."""
        obj = SparseTensor.__new__(SparseTensor)
        obj.val = val
        obj.row, obj.col = self.row, self.col
        obj.shape = self.shape
        obj.props = dict(self.props)
        obj.bell, obj.stencil = self.bell, self.stencil
        obj._plans = self._cache
        return obj

    def transpose(self) -> "SolverPlan":
        """Plan for the adjoint system Aᵀλ = g.

        Symmetric pattern → the SAME plan.  A backend may derive the adjoint
        plan from its own artifacts (block-ELL ``t_bell``, stencil planes).
        Otherwise a transposed sibling is analyzed once and cached here."""
        if self._tplan is not None:
            return self._tplan
        n, m = self.shape
        if n == m and self.props.get("symmetric", False):
            PLAN_STATS["transpose_shared"] += 1
            self._tplan = self
            return self
        tp = self.backend.transpose_plan(self)
        if tp is not None:
            PLAN_STATS["transpose_shared"] += 1
            self._tplan = tp
            return tp

        tbell = None
        if self.bell is not None:
            tbell = bell_to_device(build_bell(self.col, self.row, (m, n)),
                                   self.device)
        tcfg = self.cfg
        if tcfg.backend == "stencil" or (tcfg.backend == "pallas" and
                                         tbell is None):
            tcfg = dataclasses.replace(tcfg, backend="jnp")
            if tcfg.precond == "mg":
                tcfg = dataclasses.replace(tcfg, precond="jacobi")
        At = SparseTensor.__new__(SparseTensor)
        At.val = None
        At.row, At.col = self.col, self.row
        At.shape = (m, n)
        At.props = dict(self.props)
        At.bell, At.stencil = tbell, None
        At._plans = {}
        tplan = SolverPlan(tcfg, At, cache=At._plans)
        At._plans[tcfg.plan_key()] = tplan
        tplan._tplan = self       # (Aᵀ)ᵀ = A
        self._tplan = tplan
        return tplan

    def adapt(self, cfg: SolverConfig) -> SolverConfig:
        """Project a caller's config onto this plan's analyze-stage choices,
        keeping the caller's solve-loop knobs."""
        return dataclasses.replace(cfg, backend=self.cfg.backend,
                                   method=self.cfg.method,
                                   precond=self.cfg.precond)


def get_plan(A: SparseTensor, cfg: Optional[SolverConfig] = None,
             **kw) -> SolverPlan:
    """Fetch (or analyze-and-cache) the plan for ``A``'s pattern + ``cfg``.
    The cache lives on the SparseTensor and is SHARED by ``with_values``."""
    if cfg is None:
        cfg = make_config(A, **kw)
    elif cfg.backend in (None, "auto") or cfg.method in (None, "auto"):
        cfg = cfg.resolved(A)
    cache = getattr(A, "_plans", None)
    if cache is None:
        cache = PlanCache()
        A._plans = cache
    key = cfg.plan_key()
    plan = cache.get(key)
    if plan is not None:
        PLAN_STATS["cache_hit"] += 1
        return plan
    PLAN_STATS["cache_miss"] += 1
    plan = SolverPlan(cfg, A, cache=cache)
    cache[key] = plan
    return plan


def solve_impl(cfg: SolverConfig, A: SparseTensor, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None):
    """One un-differentiated solve through the cached plan."""
    return get_plan(A, cfg).solve(A, b, x0, cfg=cfg)
