"""Unstructured graph Laplacians (port of ``repro.data.graphs``).

The workload class the geometric multigrid cannot touch (no grid, no
stencil layout): random geometric graphs, whose SPD Laplacian is the
``precond="amg"`` test and benchmark operator.  The generator is numpy,
with the reference's random calls in the reference's order, so the COO
arrays are equal to the reference's for the same seed.  Constructors take
``device`` (default ``"cuda"``; raises without a card — pass
``device="cpu"`` for the CPU).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.sparse import SparseTensor


def geometric_graph(n: int, *, radius: float | None = None, seed: int = 0,
                    dim: int = 2) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random geometric graph on ``n`` points in the unit cube: connect
    pairs within ``radius`` (default: a ~7-neighbour average).  Returns
    ``(coords, edge_i, edge_j)`` with each undirected edge listed once
    (i < j)."""
    rng = np.random.default_rng(seed)
    coords = rng.random((n, dim))
    if radius is None:
        # π r² n ≈ 7 (2-D): connected with high probability
        radius = (7.0 / (np.pi * n)) ** 0.5 if dim == 2 \
            else (7.0 / n) ** (1.0 / dim)
    # cell binning keeps the pair search O(n) instead of O(n²)
    nb = max(int(1.0 / radius), 1)
    cell = np.minimum((coords / (1.0 / nb)).astype(np.int64), nb - 1)
    key = cell[:, 0] * nb + (cell[:, 1] if dim > 1 else 0)
    order = np.argsort(key, kind="stable")
    ptr = np.searchsorted(key[order], np.arange(nb * nb + 1))
    ei, ej = [], []
    for cx in range(nb):
        for cy in range(nb if dim > 1 else 1):
            mine = order[ptr[cx * nb + cy]:ptr[cx * nb + cy + 1]]
            if not mine.size:
                continue
            cand = [mine]
            for dx in (0, 1):
                for dy in (-1, 0, 1):
                    if (dx, dy) <= (0, 0):
                        continue
                    x2, y2 = cx + dx, cy + dy
                    if 0 <= x2 < nb and 0 <= y2 < nb:
                        cand.append(order[ptr[x2 * nb + y2]:
                                          ptr[x2 * nb + y2 + 1]])
            other = np.concatenate(cand)
            d2 = ((coords[mine][:, None, :] - coords[other][None, :, :]) ** 2
                  ).sum(-1)
            ii, jj = np.nonzero(d2 <= radius * radius)
            gi, gj = mine[ii], other[jj]
            m = gi < gj
            ei.append(gi[m])
            ej.append(gj[m])
    return coords, np.concatenate(ei), np.concatenate(ej)


def graph_laplacian(n: int, *, radius: float | None = None, seed: int = 0,
                    shift: float = 1e-2, dtype=np.float64,
                    device=None) -> SparseTensor:
    """SPD graph Laplacian L + γ·deg·I of a random geometric graph (COO).

    The γ-shift (relative to the mean degree) grounds the constant
    nullspace, like a Dirichlet boundary or a mass term: SPD, with a
    condition number that grows with the graph's diameter — where Jacobi-CG
    stalls and algebraic coarsening helps.  No stencil layout, so
    ``precond="mg"`` is inapplicable; use ``precond="amg"``."""
    _, ei, ej = geometric_graph(n, radius=radius, seed=seed)
    deg = np.bincount(np.concatenate([ei, ej]), minlength=n).astype(dtype)
    gamma = shift * max(float(deg.mean()), 1.0)
    rows = np.concatenate([np.arange(n), ei, ej])
    cols = np.concatenate([np.arange(n), ej, ei])
    vals = np.concatenate([deg + gamma,
                           -np.ones(len(ei), dtype),
                           -np.ones(len(ej), dtype)]).astype(dtype)
    props = {"symmetric": True, "spd_hint": True, "sorted_rows": False,
             "struct_full_diag": True}
    return SparseTensor(vals, rows, cols, (n, n), props=props, device=device)
