"""Preconditioners (port of ``repro.core.precond``).

Every preconditioner of the reference's single-device plan stands behind
:class:`PreconditionerPlan`, split like the reference into an eager pattern
stage (``__init__``), an arrays-only values stage
(:meth:`PreconditionerPlan.refresh_state`, run once per values tensor by the
plan's setup) and a closure assembly (:meth:`PreconditionerPlan.make_apply`,
run per solve):

* ``jacobi`` — the paper's diagonal scaling;
* ``block_jacobi`` — dense inverses of the diagonal blocks (block 128,
  ``torch.linalg.inv_ex``, a library call as the reference's
  ``jnp.linalg.inv``), applied as one batched product;
* ``chebyshev`` — the Chebyshev polynomial on Lanczos spectrum bounds
  (:func:`estimate_spectrum`, once per setup); with ``fused`` its inner step
  is the ``fused_cheb_step`` kernel;
* ``mg`` — the geometric V-cycle on the stencil planes, every smoothing
  matvec on the ``stencil5`` kernel (:mod:`repro_torch.core.multigrid`);
* ``amg`` — smoothed-aggregation AMG: numpy coarsening and Galerkin
  programs at analyze time, the numeric hierarchy per values tensor, the
  coarsest level on the direct solver's panel kernels;
* ``ilu`` — ILU(0)/IC(0) on the direct solver's machinery: the
  ``incomplete=True`` symbolic program at analyze time, its numeric
  factorization per values tensor, the factored solve as M⁻¹.

Lanes: every preconditioner sets up from stacked values (B, nnz) in one
pass — the reference's ``jax.vmap`` of the setup — into lane-stacked state:
a (B, n) diagonal, a batched block inverse, (B,) Chebyshev bounds from one
batched Lanczos run, one lane-stacked MG or AMG hierarchy, one (B, nnzF+2)
ILU factor stack.  Its apply takes (B, n) rows, row b on lane b's state.
On a one-lane state an apply takes (k, n) rows as k right-hand sides of that
one matrix.  Which of the two a state is, is read from the state itself
(:meth:`PreconditionerPlan.make_apply`), never from the row count.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["identity", "jacobi", "chebyshev", "estimate_spectrum",
           "PreconditionerPlan", "DistPreconditionerPlan",
           "make_preconditioner"]

PRECONDITIONERS = ("none", "identity", "jacobi", "block_jacobi", "chebyshev",
                   "mg", "amg", "ilu")
DIST_PRECONDITIONERS = ("none", "identity", "jacobi", "schwarz", "schwarz2")


def identity():
    return lambda r: r


def _inv_diag(d: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return torch.where(torch.abs(d) > eps, 1.0 / d, torch.ones_like(d))


def jacobi(diag: torch.Tensor, eps: float = 1e-30):
    """M⁻¹ = D⁻¹ — the paper's default for the PyTorch-native backend."""
    inv = _inv_diag(diag, eps)
    return lambda r: inv * r


# ---------------------------------------------------------------------------
# block-Jacobi
# ---------------------------------------------------------------------------

def _bj_indices(row: np.ndarray, col: np.ndarray, block: int):
    """(scatter target, in-diagonal-block mask) of COO entries — the
    pattern half of block-Jacobi (numpy)."""
    rb = row // block
    same = rb == (col // block)
    flat = (rb * block + row % block) * block + col % block
    return np.where(same, flat, 0), same


def _bj_assemble(val: torch.Tensor, safe: torch.Tensor, same: torch.Tensor,
                 nb: int, block: int) -> torch.Tensor:
    """Scatter the diagonal-block entries of ``val`` (..., nnz) into
    (..., nb, B, B); off-block entries add an explicit zero into slot 0,
    structurally empty diagonal slots (the padded tail rows) become 1."""
    contrib = torch.where(same, val, torch.zeros_like(val))
    blocks = val.new_zeros(val.shape[:-1] + (nb * block * block,))
    blocks = blocks.index_add_(-1, safe, contrib)
    blocks = blocks.reshape(val.shape[:-1] + (nb, block, block))
    ar = torch.arange(block, device=val.device)
    d = blocks[..., ar, ar]
    blocks[..., ar, ar] = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
    return blocks


def _bj_apply(inv: torch.Tensor, n: int, nb: int, block: int):
    """Block-Jacobi apply: ``inv`` (nb, B, B), or (L, nb, B, B) for lanes
    with their own values; r (n,) or (L, n) rows."""
    def apply(rvec):
        rp = torch.nn.functional.pad(rvec, (0, nb * block - n))
        out = torch.matmul(inv, rp.reshape(rp.shape[:-1] + (nb, block, 1)))
        return out.reshape(rp.shape)[..., :n]
    return apply



# ---------------------------------------------------------------------------
# Chebyshev
# ---------------------------------------------------------------------------

def _cheb_coeffs(lam_min, lam_max, degree: int):
    """θ and the recurrence's per-step scalars c1, c2 (lists of degree-1):
    floats from float bounds, f64 (B,) tensors from (B,) tensor bounds —
    the same operations in the same order either way, so a lane's scalars
    equal the single-lane ones."""
    lo, hi = (lam_min.double(), lam_max.double()) \
        if isinstance(lam_min, torch.Tensor) else (lam_min, lam_max)
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho_k = 1.0 / sigma
    c1, c2 = [], []
    for _ in range(degree - 1):
        rho_k1 = 1.0 / (2.0 * sigma - rho_k)
        c1.append(rho_k1 * rho_k)
        c2.append(2.0 * rho_k1 / delta)
        rho_k = rho_k1
    return theta, c1, c2


def chebyshev(matvec: Callable, lam_min, lam_max, degree: int = 8,
              fused: bool = False):
    """Chebyshev-polynomial approximation of A⁻¹ on [lam_min, lam_max].

    With ``fused=True`` the inner d/x axpy pair runs as one
    ``fused_cheb_step`` pass per degree; the recurrence is unchanged.
    Lanes: (B,) tensor bounds, one interval per lane of a lane-stacked
    ``matvec`` — the apply takes r (B, n), row b on lane b's interval (the
    per-lane scalars go to ``fused_cheb_step``'s lane-batched body); the
    scalars are then computed on the device, once per call here."""
    theta, c1, c2 = _cheb_coeffs(lam_min, lam_max, degree)
    lanes = isinstance(theta, torch.Tensor)
    if lanes:
        dt = lam_min.dtype
        theta = theta.to(dt)[:, None]
        c1, c2 = [c.to(dt) for c in c1], [c.to(dt) for c in c2]
    if fused:
        from ..kernels import solve_step as _fk

    def apply(r):
        x = r / theta
        rk = r - matvec(x)
        dk = x
        for a, b in zip(c1, c2):
            if fused:
                x, dk = _fk.fused_cheb_step(x, dk, rk, a, b)
            else:
                if lanes:
                    a, b = a[:, None], b[:, None]
                dk = a * dk + b * rk
                x = x + dk
            rk = rk - matvec(dk)
        return x

    return apply


def estimate_spectrum(matvec: Callable, n: int, dtype=torch.float32,
                      steps: int = 16, seed: int = 0, *, v0=None,
                      device=None, lanes: Optional[int] = None):
    """Lanczos-based extremal eigenvalue estimate for the Chebyshev bounds
    (once per setup, not per solve).  ``v0`` (tensor or numpy) replaces the
    seeded start vector.  Returns 0-dim tensors ``(λ_min, λ_max)``; with
    ``lanes`` = B (a matvec on (B, n) rows of B operators) every lane starts
    from the same vector, as under the reference's ``jax.vmap``, and the
    bounds are (B,)."""
    from .solvers import lanczos, seeded_normal
    if v0 is None:
        v0 = seeded_normal((n,), dtype, device, seed)
    else:
        v0 = torch.as_tensor(np.array(v0) if isinstance(v0, np.ndarray)
                             else v0).to(device=device, dtype=dtype)
    if lanes is not None:
        v0 = v0.expand(lanes, n).contiguous()
    a, b_, _ = lanczos(matvec, v0, steps)
    T = (torch.diag_embed(a) + torch.diag_embed(b_[..., :-1], 1)
         + torch.diag_embed(b_[..., :-1], -1))
    w = torch.linalg.eigvalsh(T)
    return w[..., 0], w[..., -1]


# ---------------------------------------------------------------------------
# plan protocol: build(pattern) eager / refresh_state(values) / make_apply
# ---------------------------------------------------------------------------

class PreconditionerPlan:
    """Pattern-level preconditioner state, reusable across values refreshes.

    ``__init__`` is the eager ``build(pattern)`` stage: it validates the
    choice against the pattern and places every values-independent artifact
    on the pattern's device once; :meth:`refresh_state` the values stage
    returning arrays only; and :meth:`make_apply` turns that state into the
    apply closure."""

    def __init__(self, name: Optional[str], row, col, shape, *,
                 stencil=None, block: int = 128, degree: int = 8):
        from ._device import to_numpy
        self.name = "none" if name in (None, "none", "identity") else name
        if self.name not in PRECONDITIONERS:
            raise ValueError(f"unknown preconditioner {name!r}")
        self.row, self.col = row, col
        self.shape = tuple(shape)
        self.stencil = stencil
        self.block = block
        self.degree = degree
        device = getattr(row, "device", torch.device("cpu"))
        if self.name == "mg":
            if stencil is None:
                raise ValueError(
                    "precond='mg' needs a stencil-layout SparseTensor "
                    "(structured-grid operator)")
            if stencil.nx != stencil.ny:
                raise ValueError("precond='mg' requires a square grid")
        if self.name == "block_jacobi":
            # eager pattern part: diagonal-block membership + scatter targets
            self.nb = -(-self.shape[0] // block)
            safe, same = _bj_indices(to_numpy(row).astype(np.int64),
                                     to_numpy(col).astype(np.int64), block)
            self._bj_idx = (torch.as_tensor(safe, device=device),
                            torch.as_tensor(same, device=device))
        if self.name == "ilu":
            # eager pattern part: the direct backend's symbolic stage in
            # zero-fill (ILU(0)) mode — structures + packed level schedule,
            # placed on the pattern's device once
            from . import direct as _direct
            art = _direct.symbolic_factor(to_numpy(row), to_numpy(col),
                                          self.shape[0], incomplete=True)
            self._ilu = _direct.to_device(art, device)
        if self.name == "amg":
            # eager pattern part: smoothed-aggregation coarsening + the
            # Galerkin index programs + the coarsest level's LDLᵀ/LU program
            from . import multigrid as _mg
            art = _mg.amg_symbolic(to_numpy(row), to_numpy(col),
                                   self.shape[0])
            self._amg = _mg.amg_to_device(art, device)

    def fused_diag(self, A) -> Optional[torch.Tensor]:
        """Diagonal-inverse vector for the fused step kernels, or None when
        the apply is not a diagonal scale — the fused solvers then keep the
        apply outside the fused pass (partial fusion)."""
        if self.name == "none":
            return torch.ones(self.shape[0], dtype=A.dtype, device=A.device)
        if self.name == "jacobi":
            return _inv_diag(A.diagonal())
        return None

    def refresh_state(self, A, matvec: Callable) -> tuple:
        """Values-dependent stage, arrays only.  Stacked values (B, nnz)
        (``matvec`` then on (B, n) rows) give lane-stacked state: every
        array of it carries the lane as its leading dim."""
        lanes = A.val.shape[0] if A.val.dim() > 1 else None
        if self.name == "none":
            return ()
        if self.name == "jacobi":
            return (_inv_diag(A.diagonal()),)
        if self.name == "block_jacobi":
            safe, same = self._bj_idx
            blocks = _bj_assemble(A.val, safe, same, self.nb, self.block)
            return (torch.linalg.inv_ex(blocks)[0],)
        if self.name == "chebyshev":
            lmin, lmax = estimate_spectrum(matvec, self.shape[0], A.dtype,
                                           device=A.device, lanes=lanes)
            lmin = torch.maximum(lmin, lmax * 1e-4)
            return (lmin, lmax)
        if self.name == "mg":
            from .multigrid import MultigridPreconditioner
            nx, ny = self.stencil.nx, self.stencil.ny
            v5 = A.val.reshape(A.val.shape[:-1] + (5, nx, ny))
            return MultigridPreconditioner.from_planes(v5).state()
        if self.name == "ilu":
            from . import direct as _direct
            return (_direct.numeric_factor(self._ilu, A.val),)
        if self.name == "amg":
            from . import multigrid as _mg
            return _mg.amg_numeric(self._amg, A.val)
        raise ValueError(f"unknown preconditioner {self.name!r}")

    def make_apply(self, state, matvec: Callable,
                   fused: bool = False) -> Callable:
        """Apply closure over a :meth:`refresh_state` tuple.  On a one-lane
        state it takes r (n,) or (k, n) rows, k right-hand sides of the one
        matrix (MG, AMG: one V-cycle for all rows; ILU: one multi-rhs
        factored solve).  On a lane-stacked state (from stacked values) it takes
        r (B, n), row b on lane b's state, all lanes at once (one V-cycle,
        one lane-stacked factored solve, per-lane Chebyshev scalars).
        ``fused`` routes Chebyshev's inner step through ``fused_cheb_step``;
        it is a solve-time decision, never part of the state."""
        if self.name == "none":
            return identity()
        if self.name == "jacobi":
            (inv,) = state
            return lambda r: inv * r
        if self.name == "block_jacobi":
            (inv,) = state
            return _bj_apply(inv, self.shape[0], self.nb, self.block)
        if self.name == "chebyshev":
            lmin, lmax = state
            if lmin.dim() == 0:
                # the bounds as host floats: one read per solve, and the
                # recurrence's scalars launch nothing
                lmin, lmax = float(lmin), float(lmax)
            # else (B,) lane bounds stay on the device: the per-lane
            # scalars are computed there once per solve
            return chebyshev(matvec, lmin, lmax, degree=self.degree,
                             fused=fused)
        if self.name == "mg":
            from .multigrid import MultigridPreconditioner
            return MultigridPreconditioner.from_state(state)
        if self.name == "ilu":
            from . import direct as _direct
            art = self._ilu
            (C,) = state

            def ilu(r):
                if r.dim() == 1 or C.dim() == 2:   # one rhs, or one per lane
                    return _direct.factored_solve(art, C, r)
                return _direct.factored_solve(art, C, r.T).T
            return ilu
        if self.name == "amg":
            from .multigrid import AMGPreconditioner
            return AMGPreconditioner(self._amg, state)
        raise ValueError(f"unknown preconditioner {self.name!r}")

    @staticmethod
    def lane_state(state, i: int):
        """Lane i of a lane-stacked :meth:`refresh_state` tuple (every array
        in it carries the lane as its leading dim): the one-lane state of
        that lane's values."""
        if isinstance(state, torch.Tensor):
            return state[i]
        return type(state)(PreconditionerPlan.lane_state(t, i)
                           for t in state)

    def refresh(self, A, matvec: Callable, fused: bool = False) -> Callable:
        """:meth:`refresh_state` + :meth:`make_apply` in one call."""
        return self.make_apply(self.refresh_state(A, matvec), matvec,
                               fused=fused)


class DistPreconditionerPlan:
    """Distributed preconditioner on the stacked storage of a
    ``DSparseTensor``, split like :class:`PreconditionerPlan`: the pattern
    stage in ``__init__`` (the whole pattern's stacks (P, nnz_loc), on the
    host; every rank runs it alike and places its own shards' arrays), the
    values stage :meth:`refresh`, and the apply :meth:`local_closure` on
    this rank's (P_loc, n_loc) stacks.

    * ``jacobi`` — the per-shard diagonal-entry mask (pads excluded);
      ``refresh`` is one masked segment sum.
    * ``schwarz`` — shard-local overlapping Schwarz: each shard's extended
      matrix ``A[ext, ext]`` (owned rows ∪ halo-overlap rows, Dirichlet
      truncation — a principal submatrix, so SPD stays SPD) is analyzed
      ONCE through the direct solver's union-pattern ILU(0)/IC(0) program
      (:func:`repro_torch.core.direct.schwarz_symbolic`); ``refresh`` is
      one lane-stacked numeric pass with the rank's shards as lanes (the
      overlap rows' values come from the neighbour shards, so the values
      are all-gathered first); the apply is halo → the lanes' triangular
      sweeps → transposed halo (Σ Rᵀ A_ext⁻¹ R).
    * ``schwarz2`` — adds the coarse level: the tentative aggregation of
      the GLOBAL pattern, its Galerkin matrix as ONE segment sum of the
      values and its direct factors — computed identically on every rank
      (replicated state, :meth:`state_sharded`).  The apply all-gathers the
      residual, aggregates, solves on the coarse factors and scatters, in
      the symmetric deflated two-level form."""

    def __init__(self, name: Optional[str], lrow, lcol, meta, *, bounds,
                 mesh, coarsest: int = 160):
        self.name = "none" if name in (None, "none", "identity") else name
        if self.name not in DIST_PRECONDITIONERS:
            raise ValueError(
                f"unknown distributed preconditioner {name!r} "
                f"(supported: {DIST_PRECONDITIONERS})")
        self.meta, self.mesh = meta, mesh
        dev, sl = mesh.device, mesh.shards
        lr = np.asarray(lrow)
        lc = np.asarray(lcol)
        p, nnz_loc = lr.shape
        valid = np.arange(nnz_loc)[None, :] < \
            np.asarray(meta.shard_nnz)[:, None]
        if self.name == "jacobi":
            q = np.arange(mesh.p_loc)[:, None]
            dmask = ((lr + meta.h_lo == lc) & valid)[sl]
            keep = np.flatnonzero(dmask)
            self._d_idx = torch.as_tensor(keep, device=dev)
            self._d_row = torch.as_tensor(
                (q * meta.n_loc + lr[sl]).reshape(-1)[keep], device=dev)
        if self.name in ("schwarz", "schwarz2"):
            from . import direct as _direct
            from .distributed import global_entries
            h_lo, h_hi, n_loc = meta.h_lo, meta.h_hi, meta.n_loc
            n_ext = h_lo + n_loc + h_hi
            row_g, col_g, fa = global_entries(lr, lc, meta, bounds)
            entries = []
            for q in range(p):
                lo = bounds[q] - h_lo
                hi = bounds[q] + n_loc + h_hi     # uniform n_ext window
                m = ((row_g >= lo) & (row_g < hi) &
                     (col_g >= lo) & (col_g < hi))
                entries.append((row_g[m] - lo, col_g[m] - lo, fa[m]))
            self.schwarz = _direct.schwarz_symbolic(entries, n_ext,
                                                    n_src=p * nnz_loc)
            self._schwarz = _direct.schwarz_to_device(self.schwarz, dev, sl)
        if self.name == "schwarz2":
            from . import direct as _direct
            from .sparse import tentative_coarse_pattern
            agg, n_c, e2c, crow, ccol = tentative_coarse_pattern(
                row_g, col_g, meta.n, coarsest=coarsest)
            self._coarse_art = _direct.to_device(
                _direct.symbolic_factor(crow, ccol, n_c), dev)
            self._n_c = n_c
            self._c_nnz = len(crow)
            self._c_fa = torch.as_tensor(fa, device=dev)
            self._c_e2c = torch.as_tensor(e2c, device=dev)
            # owned-row → coarse-node map, padded tail rows → dump slot n_c
            own = np.full((p, n_loc), n_c, np.int64)
            for q in range(p):
                cnt = int(bounds[q + 1] - bounds[q])
                own[q, :cnt] = agg[bounds[q]:bounds[q + 1]]
            self._own2coarse = torch.as_tensor(own, device=dev)

    def state_sharded(self) -> tuple:
        """Per-leaf layout of :meth:`refresh`'s output: True → this rank's
        rows of a (P, ·) stack, False → replicated (the two-level coarse
        factor, computed identically on every rank)."""
        if self.name == "none":
            return ()
        if self.name == "schwarz2":
            return (True, False)
        return (True,)

    def refresh(self, lval: torch.Tensor) -> tuple:
        """The values stage on this rank's stacked values (P_loc,
        nnz_loc)."""
        if self.name == "none":
            return ()
        if self.name == "jacobi":
            m = self.mesh
            d = lval.new_zeros(m.p_loc * self.meta.n_loc)
            d.index_add_(0, self._d_row, lval.reshape(-1)[self._d_idx])
            d = d.view(m.p_loc, self.meta.n_loc)
            return (_inv_diag(d),)
        from . import direct as _direct
        from .distributed import _gather_shards
        flat = _gather_shards(self.mesh, lval).reshape(-1)
        C = _direct.schwarz_numeric(self._schwarz, flat)
        if self.name == "schwarz":
            return (C,)
        # coarse Galerkin values Tᵀ A T: every tentative-prolongator entry
        # is 1, so the triple product is ONE segment sum of the flat values
        c_val = flat.new_zeros(self._c_nnz).index_add_(
            0, self._c_e2c, flat[self._c_fa])
        Cc = _direct.numeric_factor(self._coarse_art, c_val)
        return (C, Cc)

    def local_closure(self, state, halo_fwd: Callable, halo_bwd: Callable,
                      matvec: Optional[Callable] = None) -> Callable:
        """The apply on (P_loc, n_loc) stacks.  ``halo_fwd``/``halo_bwd``
        are H and Hᵀ; ``matvec`` (the halo'd local SpMV) is needed by the
        two-level mode's deflation products."""
        if self.name == "none":
            return identity()
        if self.name == "jacobi":
            (inv,) = state
            return lambda r: inv * r
        from . import direct as _direct
        C = state[0]
        art = self._schwarz.art

        def apply(r):
            z_ext = _direct.factored_solve(art, C, halo_fwd(r))
            return halo_bwd(z_ext)         # Σ Rᵀ A_ext⁻¹ R: overlap summed

        if self.name == "schwarz":
            return apply
        if matvec is None:
            raise ValueError("schwarz2 needs the shard-local matvec")
        from .distributed import _gather_shards
        Cc = state[1]
        c_art, own, n_c = self._coarse_art, self._own2coarse, self._n_c
        own_loc = own[self.mesh.shards]

        def coarse(r):
            # Q r = T A_c⁻¹ Tᵀ r: gather the global residual, aggregate,
            # solve on the replicated coarse factors, scatter to own rows
            r_all = _gather_shards(self.mesh, r)            # (P, n_loc)
            rc = r.new_zeros(n_c + 1).index_add_(
                0, own.reshape(-1), r_all.reshape(-1))[:n_c]
            zc = _direct.factored_solve(c_art, Cc, rc)
            return torch.cat([zc, zc.new_zeros(1)])[own_loc]

        def apply2(r):
            # symmetric deflated two-level (BNN/ADEF-2 form):
            #   M = Q + (I − Q A) M_AS (I − A Q)
            zc = coarse(r)
            w = apply(r - matvec(zc))
            return zc + w - coarse(matvec(w))

        return apply2


def make_preconditioner(name: str, A, matvec: Callable) -> Callable:
    """One-shot factory: build(pattern) + refresh(values) in one call.
    Prefer going through a ``SolverPlan`` so the build stage is cached."""
    plan = PreconditionerPlan(name, A.row, A.col, A.shape,
                              stencil=A.stencil)
    return plan.refresh(A, matvec)
