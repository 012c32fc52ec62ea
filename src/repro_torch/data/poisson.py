"""Poisson problem generators (port of ``repro.data.poisson``).

``poisson2d``    : constant-coefficient 5-point Laplacian, COO, Dirichlet.
``poisson2d_vc`` : variable-coefficient −∇·(κ∇u) cell-centred FD assembly,
                   differentiable in κ, with COO and stencil-kernel layouts.
``poisson1d``    : tridiagonal, for cheap unit tests.

Every constructor takes ``device`` (default ``"cuda"``; raises without a
card — pass ``device="cpu"`` for the CPU).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core._device import resolve_device
from ..core.sparse import SparseTensor
from ..kernels.stencil5 import Stencil5Meta


def poisson1d(n: int, dtype=np.float64, device=None) -> SparseTensor:
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)]).astype(dtype)
    return SparseTensor(vals, rows, cols, (n, n), device=device)


def poisson2d_arrays(ng: int, dtype=np.float64):
    """``(val, row, col)`` numpy arrays of :func:`poisson2d` (same entry
    order as the reference)."""
    n = ng * ng
    idx = np.arange(n).reshape(ng, ng)
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(n, 4.0, dtype)]
    for (di, dj) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        src = idx[max(0, -di):ng - max(0, di), max(0, -dj):ng - max(0, dj)]
        dst = idx[max(0, di):ng - max(0, -di), max(0, dj):ng - max(0, -dj)]
        rows.append(src.ravel())
        cols.append(dst.ravel())
        vals.append(np.full(src.size, -1.0, dtype))
    return np.concatenate(vals), np.concatenate(rows), np.concatenate(cols)


def poisson2d(ng: int, dtype=np.float64, build_kernel_layout: bool = False,
              device=None) -> SparseTensor:
    """ng×ng interior points, unit-scaled 5-point Laplacian."""
    val, row, col = poisson2d_arrays(ng, dtype)
    return SparseTensor(val, row, col, (ng * ng, ng * ng),
                        build_kernel_layout=build_kernel_layout, device=device)


# ---------------------------------------------------------------------------
# variable-coefficient assembly (differentiable in κ)
# ---------------------------------------------------------------------------

def vc_pattern(ng: int) -> Tuple[np.ndarray, np.ndarray, Stencil5Meta]:
    """COO pattern matching the (5, ng, ng) signed coefficient planes of the
    stencil kernel: entry order = planes (C, N, S, W, E) × row-major cells;
    out-of-domain neighbours keep a slot with a structurally-zero value (and
    a clamped in-range column) so COO and stencil layouts share one ``val``."""
    idx = np.arange(ng * ng).reshape(ng, ng)
    rows, cols = [], []
    offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    for (di, dj) in offs:
        ii = np.clip(np.arange(ng)[:, None] + di, 0, ng - 1)
        jj = np.clip(np.arange(ng)[None, :] + dj, 0, ng - 1)
        rows.append(idx.ravel())
        cols.append(idx[ii, jj].ravel())
    return np.concatenate(rows), np.concatenate(cols), Stencil5Meta(nx=ng, ny=ng)


def vc_coefficients(kappa: torch.Tensor) -> torch.Tensor:
    """κ (ng, ng) cell conductivities → signed planes (5, ng, ng), flattened.

    Face coefficient = harmonic mean of adjacent cells; Dirichlet u=0 via
    boundary faces with coefficient κ_cell.  Differentiable in κ."""
    ng = kappa.shape[0]
    ar = torch.arange(ng, device=kappa.device)
    first_row, last_row = ar[:, None] > 0, ar[:, None] < ng - 1
    first_col, last_col = ar[None, :] > 0, ar[None, :] < ng - 1

    def hmean(a, b):
        return 2.0 * a * b / (a + b + 1e-30)

    kN = torch.where(first_row, hmean(kappa, torch.roll(kappa, 1, 0)), kappa)
    kS = torch.where(last_row, hmean(kappa, torch.roll(kappa, -1, 0)), kappa)
    kW = torch.where(first_col, hmean(kappa, torch.roll(kappa, 1, 1)), kappa)
    kE = torch.where(last_col, hmean(kappa, torch.roll(kappa, -1, 1)), kappa)
    C = kN + kS + kW + kE
    zero = torch.zeros((), dtype=kappa.dtype, device=kappa.device)
    # neighbour couplings: zero at the domain boundary (Dirichlet)
    N = torch.where(first_row, -kN, zero)
    S = torch.where(last_row, -kS, zero)
    W = torch.where(first_col, -kW, zero)
    E = torch.where(last_col, -kE, zero)
    return torch.stack([C, N, S, W, E]).reshape(-1)


def poisson2d_vc(kappa, *, use_stencil_kernel: bool = False,
                 device=None) -> SparseTensor:
    """Assemble A(κ) as a SparseTensor (values differentiable in κ)."""
    dev = resolve_device(device)
    if not isinstance(kappa, torch.Tensor):
        kappa = torch.as_tensor(np.asarray(kappa))
    kappa = kappa.to(dev)
    ng = kappa.shape[0]
    rows, cols, meta = vc_pattern(ng)
    props = {"symmetric": True, "spd_hint": True, "sorted_rows": False}
    return SparseTensor(vc_coefficients(kappa), rows, cols, (ng * ng, ng * ng),
                        props=props,
                        stencil=meta if use_stencil_kernel else None,
                        validate=False, device=dev)
