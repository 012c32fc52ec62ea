"""Sparse direct factorization — the cuDSS analogue (port of
``repro.core.direct``).

``symbolic_factor(row, col, n)`` — the analyze stage: numpy, values-free,
a copy of the reference's (AMD on a quotient graph, exact MD, RCM or
natural ordering; the etree fill pass; the packed scalar step program; the
supernodal panel program with static Bunch–Kaufman 2x2 pairs).  It returns
numpy artifacts, array-equal to the reference's, with one change: the
scalar packed program (``factor``, ``row_sweep``, ``col_sweep``) is emitted
only where it runs — when no supernodal program is emitted, or for
``incomplete=True``.  With the panel program present those fields are None
(the reference emits them too and never reads them; at n ≈ 10⁵ they are
8 GB).  Their step count and update count still fill ``stats``.

``to_device(art, device)`` places the artifacts on a device once, at
analyze time: the panel slot tables as int32 (the kernels read them), the
extend-add targets as a live-only int32 table with per-lane offsets, the
other index arrays as int64, plus per-bucket masks and row splits the
sweeps read.

``numeric_factor(dart, val)`` — the setup stage.  Supernodal: per bucket,
two kernels that work on ``C`` in place through the slot tables:
``panel_factor`` factors the panels, ``schur_update`` subtracts the Schur
product straight from the ancestors' slots (the extend-add).  Otherwise
the scalar packed scan, a Python loop over its steps (ILU(0), and patterns
the supernodal gate declines).  ``factored_solve(dart, C, b)`` — the solve
stage: supernodal sweeps, one ``sn_sweep`` kernel per bucket and sweep
(block solve, panel GEMV and scatter / gather, in place in the solution),
or the scalar sweeps; ``b`` may be (n,) or (n, m).
``factor_slogdet`` — (sign, log|det A|) from the factors, pair aware.

Storage layout of the factor vector ``C`` (length ``nnzF + 2``), as in the
reference::

    C[0:n]              pivots  U[k,k]              (permuted order)
    C[n:n+nnzL]         L entries, column-major     (unit diagonal implicit)
    C[n+nnzL:nnzF]      U entries, mirror-aligned   (U[j,k] at mirror of L[k,j])
    C[nnzF]             scratch 0  (the pads' slot; never written)
    C[nnzF+1]           scratch 1  (padding divisor — keeps pads NaN-free)

The scalar program reads ``C[nnzF]`` as a scratch zero; the supernodal
one's pad slots all name it, and its kernels read them masked and never
write them.  On CUDA ``schur_update`` sums sibling lanes' updates into a
shared target with atomics, so f64 factors can differ in the last bits from
run to run.
"""
from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DirectArtifacts", "symbolic_factor", "to_device", "numeric_factor",
    "factored_solve", "factor_slogdet",
]

SN_MAX_W = 32            # supernode width cap (panel column count per bucket)


class PackedFactor(NamedTuple):
    """Step program for the numeric factorization, all arrays (S, width).
    Per step: ``C[fin_lpos] /= C[fin_piv]`` (column finalize), then
    ``C[up_dst] -= C[up_s1] * C[up_s2]`` (right-looking updates).  Pads point
    at the scratch slots, so they are exact no-ops."""
    fin_lpos: np.ndarray
    fin_piv: np.ndarray
    up_s1: np.ndarray
    up_s2: np.ndarray
    up_dst: np.ndarray


class PackedSweep(NamedTuple):
    """Step program for one triangular-sweep direction ((S, width)).

    ``row`` program (levels leaf→root): forward-L (``lpos``) and
    transposed-Uᵀ (``upos`` + divides).  ``col`` program (root→leaf):
    backward-U (``upos`` + divides) and transposed-Lᵀ (``lpos``).  Per step:
    ``y[tgt] -= C[pos] * y[src]`` then optionally ``y[dn] /= C[dpiv]``.
    The solution vector carries one scratch element at index n for pads."""
    tgt: np.ndarray
    src: np.ndarray
    lpos: np.ndarray
    upos: np.ndarray
    dn: np.ndarray
    dpiv: np.ndarray


class SnodeBucket(NamedTuple):
    """One (assembly-level, padded-shape) bucket of supernodes.

    ``k`` lanes share the padded panel shape (wb, rb); lanes past the true
    count are all-pad (``wvec = 0``, slots at the scratch sink).  The index
    arrays address ``C``: ``pidx`` (k, wb+rb, wb) the P panel, ``qidx``
    (k, wb, rb) the U panel, ``uidx`` (k, rb, rb) the extend-add targets,
    ``rows`` (k, wb+rb) permuted row ids (pads → n), ``bkm`` (k, wb) pair
    starts.  On the device (:func:`to_device`) ``uidx`` is live-only: the
    concatenated r×r blocks of the lanes, lane l's at ``uoff[l]`` (set by
    :func:`to_device` only, (k+1,))."""
    wb: int
    rb: int
    pairs: bool
    pidx: np.ndarray
    qidx: np.ndarray
    uidx: np.ndarray
    rows: np.ndarray
    wvec: np.ndarray         # (k,) true widths
    rvec: np.ndarray         # (k,) true sub-row counts
    bkm: np.ndarray
    uoff: Optional[torch.Tensor] = None


class SnodeProgram(NamedTuple):
    """Supernodal panel program.  ``schedule`` is a tuple of assembly-tree
    levels, each a tuple of :class:`SnodeBucket`: ascending for the
    factorization and the L/Uᵀ sweeps, descending for U/Lᵀ.  ``pair_cols``
    (p, 2) permuted pivot columns of the 2x2 pairs, ``pair_off`` (p, 2) the
    C slots of their raw b and c entries, ``unpaired`` (n,) the columns
    owned by 1x1 pivots (read by :func:`factor_slogdet`).  ``buffers``
    (set by :func:`to_device`) holds the sweep kernel's work buffers, made
    at the first solve and kept (:func:`_sweep_buffers`)."""
    schedule: tuple
    pair_cols: np.ndarray
    pair_off: np.ndarray
    unpaired: np.ndarray
    stats: dict              # n_snodes, mean_width, panel_fraction, n_groups
    buffers: Optional[dict] = None


class DirectArtifacts(NamedTuple):
    """Product of the symbolic analysis — pattern-only, shared by every
    ``with_values`` refresh and the adjoint.  ``factor``/``row_sweep``/
    ``col_sweep`` are None when ``snode`` is present."""
    n: int
    nnzF: int
    perm: np.ndarray         # perm[k] = original index eliminated at step k
    ipos: np.ndarray         # ipos[v] = elimination position of index v
    a2f: np.ndarray          # COO entry e -> position in C (scatter-add)
    factor: Optional[PackedFactor]
    row_sweep: Optional[PackedSweep]
    col_sweep: Optional[PackedSweep]
    stats: dict              # nnz_L, fill_ratio, n_levels, flops, n_steps
    snode: Optional[SnodeProgram] = None    # dense-panel program (else scalar)


# ---------------------------------------------------------------------------
# symbolic analysis (numpy — the analyze stage, once per pattern)
# ---------------------------------------------------------------------------

def _sym_lower_csr(row: np.ndarray, col: np.ndarray, n: int,
                   ipos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of the *strict lower triangle* of the permuted, symmetrized
    pattern: returns ``(rptr, rcol)`` — for permuted row ``i``, the sorted
    permuted indices ``j < i`` with ``A(perm[i], perm[j]) != 0`` (either
    triangle).  Duplicates collapse; the diagonal is dropped."""
    mask = row != col
    pi = ipos[row[mask]]
    pj = ipos[col[mask]]
    hi = np.maximum(pi, pj)
    lo = np.minimum(pi, pj)
    keys = np.unique(hi * np.int64(n) + lo)
    ri = keys // n
    rj = keys % n
    rptr = np.searchsorted(ri, np.arange(n + 1, dtype=np.int64))
    return rptr, rj


def _rcm_order(row: np.ndarray, col: np.ndarray, n: int) -> np.ndarray:
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except Exception:                       # scipy absent — degrade gracefully
        return np.arange(n, dtype=np.int64)
    G = sp.csr_matrix((np.ones(len(row)), (row, col)), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee(G, symmetric_mode=False),
                      dtype=np.int64)


def _sym_adj_sets(row: np.ndarray, col: np.ndarray, n: int) -> List[set]:
    """Per-vertex neighbour sets of the symmetrized pattern graph (no self
    loops, duplicates collapsed) — the shared starting point of both
    degree-based orderings."""
    mask = row != col
    rr = np.concatenate([row[mask], col[mask]])
    cc = np.concatenate([col[mask], row[mask]])
    key = np.unique(rr * np.int64(n) + cc)
    ai = (key // n).astype(np.int64)
    aj = (key % n).astype(np.int64)
    ptr = np.searchsorted(ai, np.arange(n + 1, dtype=np.int64))
    return [set(aj[ptr[v]:ptr[v + 1]].tolist()) for v in range(n)]


def _exact_md_order(row: np.ndarray, col: np.ndarray, n: int) -> np.ndarray:
    """Exact minimum degree: full graph elimination with clique formation,
    selecting the minimum *remaining* degree each step.  O(fill) set algebra
    per pivot — the quality yardstick ``ordering="amd"`` is measured against
    (tests assert AMD fill-in stays within 25%), not the production path."""
    adj = _sym_adj_sets(row, col, n)
    INF = np.int64(1) << np.int64(60)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    for k in range(n):
        v = int(np.argmin(deg))
        perm[k] = v
        deg[v] = INF
        nb = adj[v]
        for u in nb:
            adj[u].discard(v)
        for u in nb:
            au = adj[u]
            au |= nb
            au.discard(u)
            deg[u] = len(au)
        adj[v] = set()
    return perm


def _amd_order(row: np.ndarray, col: np.ndarray, n: int, *,
               aggressive: bool = True) -> np.ndarray:
    """Approximate minimum degree on a quotient graph (Amestoy/Davis/Duff).

    Instead of forming the clique of each eliminated vertex (the O(fill)
    step that makes exact MD quadratic-ish in practice), the eliminated
    pivot becomes an *element* whose boundary list represents the clique
    implicitly.  Per pivot:

    - the pivot structure ``Lp`` is the union of its variable neighbours and
      the boundaries of its elements, which are *absorbed* into the new
      element (each element is scanned O(1) times over its life);
    - every ``v ∈ Lp`` gets an **approximate** external degree
      ``d(v) ≈ |A_v| + |Lp \\ v| + Σ_e |Le \\ Lp|`` (the classic AMD upper
      bound — element overlaps are counted once per element, not exactly),
      clamped by ``n_left - |v|`` and ``d_old + |Lp \\ v|``;
    - elements with ``|Le \\ Lp| = 0`` are **aggressively absorbed**;
    - variables whose entire structure is inside ``Lp`` are
      **mass-eliminated** with the pivot (no new fill, no new pivot search);
    - variables in ``Lp`` with identical quotient adjacency (same pruned
      variable set, same element set) are detected via a hash bucket over
      ``Σ ids`` and merged into **supervariables**, eliminated together.

    Returns the elimination permutation (supervariables expanded in merge
    order).  Degrees are weighted by supervariable size throughout, so the
    approximation tracks the true external degree of the compressed graph.
    """
    if n == 0:
        return np.empty(0, dtype=np.int64)
    INF = np.int64(1) << np.int64(60)
    adj = _sym_adj_sets(row, col, n)
    elem: List[list] = [[] for _ in range(n)]   # element lists per variable
    Le: dict = {}                               # alive elements: id -> [vars]
    wt = [1] * n                                # supervariable weights
    members: List[list] = [[v] for v in range(n)]
    status = [0] * n                            # 0 alive, 1 ordered, 2 merged
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    order: List[int] = []
    nleft = n
    while nleft > 0:
        p = int(np.argmin(deg))
        # ---- pivot structure Lp = (A_p ∪ ⋃ Le[e]) \ {p, dead} -------------
        Lp_set: set = set()
        for e in elem[p]:
            le = Le.pop(e, None)                # absorb e into the new element
            if le is not None:
                Lp_set.update(le)
        Lp_set.update(adj[p])
        Lp = [v for v in Lp_set if status[v] == 0 and v != p]
        Lp_set = set(Lp)
        order.append(p)
        status[p] = 1
        deg[p] = INF
        nleft -= wt[p]
        adj[p] = set()
        elem[p] = []
        if not Lp:
            continue
        WLp = 0
        for v in Lp:
            WLp += wt[v]
        # ---- scan 1: prune neighbour lists, weigh |Le \ Lp| per element ---
        wext: dict = {}
        for v in Lp:
            av = adj[v]
            if av:
                adj[v] = {u for u in av
                          if status[u] == 0 and u not in Lp_set}
            ev = []
            for e in elem[v]:
                le = Le.get(e)
                if le is None:                  # absorbed earlier — drop
                    continue
                w = wext.get(e)
                if w is None:                   # first touch: compact + weigh
                    le2 = [u for u in le if status[u] == 0]
                    if len(le2) != len(le):
                        Le[e] = le = le2
                    w = 0
                    for u in le:
                        w += wt[u]
                wext[e] = w - wt[v]
                ev.append(e)
            elem[v] = ev
        Le[p] = Lp
        # ---- scan 2: approximate degrees, absorption, mass elim, hashing --
        buckets: dict = {}
        mass: List[int] = []
        for v in Lp:
            ext = 0
            ev2 = []
            for e in elem[v]:
                w = wext[e]
                if w <= 0 and aggressive:
                    Le.pop(e, None)             # Le[e] ⊆ Lp: absorbed by p
                    continue
                ev2.append(e)
                ext += w
            da = 0
            for u in adj[v]:
                da += wt[u]
            if ext == 0 and da == 0:
                elem[v] = []                    # struct(v) ⊆ Lp: mass elim
                mass.append(v)
                continue
            ev2.append(p)
            elem[v] = ev2
            d = da + (WLp - wt[v]) + ext
            bound = nleft - wt[v]
            if d > bound:
                d = bound
            ob = int(deg[v]) + WLp - wt[v]
            if d > ob:
                d = ob
            deg[v] = d
            h = 0
            for e in ev2:
                h += e
            for u in adj[v]:
                h += u
            buckets.setdefault(h % 1048573, []).append(v)
        for v in mass:
            order.append(v)
            status[v] = 1
            deg[v] = INF
            nleft -= wt[v]
            adj[v] = set()
        if mass:
            mset = set(mass)
            Le[p] = [v for v in Lp if v not in mset]
        # ---- supervariable merging (exact check within hash buckets) ------
        for bucket in buckets.values():
            if len(bucket) < 2:
                continue
            for k, v in enumerate(bucket):
                if status[v] != 0:
                    continue
                ve = None
                for u in bucket[k + 1:]:
                    if status[u] != 0 or len(elem[u]) != len(elem[v]):
                        continue
                    if ve is None:
                        ve = set(elem[v])
                    if adj[u] == adj[v] and ve == set(elem[u]):
                        wt[v] += wt[u]          # merge u into v
                        members[v].extend(members[u])
                        members[u] = []
                        status[u] = 2
                        deg[u] = INF
                        deg[v] -= wt[u]
                        adj[u] = set()
                        elem[u] = []
    perm = np.empty(n, dtype=np.int64)
    k = 0
    for r in order:
        for v in members[r]:
            perm[k] = v
            k += 1
    assert k == n, "AMD lost variables (quotient-graph bookkeeping bug)"
    return perm


def _etree_fill(n: int, rptr: np.ndarray, rcol: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Elimination tree + static fill pattern + level schedule in O(nnz(L)).

    One pass of Liu's etree construction fused with the row-subtree
    traversal: for permuted row ``i``, walking from every pattern entry
    ``k < i`` up the partial etree emits exactly the nonzeros of row ``i``
    of L (the walk is pruned at the first vertex already marked for ``i``,
    so each L entry is produced exactly once — the filled graph is never
    materialized).  Longest-path levels of the elimination DAG
    (``level(i) > level(j)`` for every L(i,j)) ride the same pass.

    Returns ``(Ri, Rj, level, parent)`` — L entries as (row, col) index
    arrays in permuted coordinates, the per-node level, and the etree parent
    (-1 at roots; the supernode partition reads ``parent[j] == j+1`` chains).
    """
    parent = [-1] * n
    mark = [-1] * n
    level = [0] * n
    ei: List[int] = []
    ej: List[int] = []
    rp = rptr.tolist()
    rc = rcol.tolist()
    for i in range(n):
        mark[i] = i
        lv = -1
        for t in range(rp[i], rp[i + 1]):
            j = rc[t]
            while mark[j] != i:
                mark[j] = i
                ei.append(i)
                ej.append(j)
                lj = level[j]
                if lj > lv:
                    lv = lj
                pj = parent[j]
                if pj == -1:
                    parent[j] = i
                    break
                j = pj
        level[i] = lv + 1
    return (np.asarray(ei, dtype=np.int64), np.asarray(ej, dtype=np.int64),
            np.asarray(level, dtype=np.int64),
            np.asarray(parent, dtype=np.int64))


def _pattern_levels(n: int, rptr: np.ndarray, rcol: np.ndarray) -> np.ndarray:
    """Longest-path levels when the L structure IS the (permuted strict
    lower) pattern — the zero-fill ILU(0)/IC(0) case needs no etree."""
    level = [0] * n
    rp = rptr.tolist()
    rc = rcol.tolist()
    for i in range(n):
        lv = -1
        for t in range(rp[i], rp[i + 1]):
            lj = level[rc[t]]
            if lj > lv:
                lv = lj
        level[i] = lv + 1
    return np.asarray(level, dtype=np.int64)


def _width(total: int, n_levels: int, lo: int = 32, hi: int = 1 << 16) -> int:
    """Step width ≈ mean level load, clamped and rounded DOWN to a power of
    two — few distinct shapes across patterns keeps XLA's compile cache
    warm, and the floor (vs the previous ceil) cuts the padded step area by
    ~30% on 2-D Poisson at n = 10⁴, which speeds the numeric factorization
    and the sweeps by the same fraction (the scan does strictly less padded
    work; measured 17–20% faster end-to-end)."""
    w = max(lo, min(hi, -(-total // max(n_levels, 1))))
    return 1 << max(int(np.floor(np.log2(w))), 5)


def _emit_factor(n: int, nnzL: int, Li: np.ndarray, Lptr: np.ndarray,
                 counts: np.ndarray, level: np.ndarray, n_levels: int,
                 lkeys: np.ndarray, incomplete: bool, emit: bool = True
                 ) -> Tuple[Optional[PackedFactor], int, int]:
    """Packed factorization program, emitted with vectorized placement.

    Columns are walked level by level (elimination DAG order).  Within one
    step the scan body runs finalize-then-update, so a column's updates may
    share its finalize step; a new level's finalizes must start strictly
    after any step holding earlier levels' updates (those updates write into
    the new level's entries and pivots).  Placement replicates the greedy
    fixed-width packer with prefix sums: finalize entries of a level are
    consecutive from ``max(cursor, ceil(up_cursor/w_up))``; each column's
    update tuples start no earlier than the step of its last finalize, which
    a running-max scan over ``f_i·w_up − Σ u_j`` resolves level-wide without
    a Python per-tuple loop.  ``lkeys`` is the sorted column-major key array
    ``col·n + row`` of L used to resolve update destinations (an update pair
    (i, j) maps to the diagonal, an L slot, or its mirrored U slot).

    Returns ``(program, n_steps, kept_updates)``.  With ``emit=False``
    (complete factorizations whose supernodal program runs instead) only the
    per-column placement runs: the step count and update count come out
    the same and the program is None — no update tuple is ever built.
    """
    szero = n + 2 * nnzL                       # scratch slots in C
    sone = szero + 1
    flops = int(np.sum(counts.astype(np.int64) ** 2))
    wf = _width(nnzL, n_levels)
    wu = _width(flops, n_levels)

    # ---- values (one vectorized pass over all levels) ---------------------
    # Columns in schedule order (level, then index); every T-sized array is
    # built globally — only the *placement* below walks levels, and it only
    # touches per-column scalars.
    colorder = np.argsort(level, kind="stable").astype(np.int64)
    lvl_cnt = np.bincount(level, minlength=n_levels)
    lvl_ptr = np.concatenate([[0], np.cumsum(lvl_cnt)])
    m = counts[colorder]
    mex = np.concatenate([[0], np.cumsum(m)])          # fin offsets/column
    if not (emit or incomplete):
        P = (m * (m - 1)) // 2                         # strict pairs/column
        n_pairs = int(P.sum())
    else:
        Li32 = Li.astype(np.int32)
        F = int(mex[-1])                                   # == nnzL
        cid = np.repeat(np.arange(n, dtype=np.int64), m)   # fin item -> col
        lbase = Lptr[colorder]
        lidx = lbase[cid] + (np.arange(F, dtype=np.int64) - mex[cid])
        finl = (n + lidx).astype(np.int32)                 # fin lpos values
        finp = colorder[cid].astype(np.int32)              # fin pivot values
        rows = Li32[lidx]                                  # permuted row
        # update tuples: every (a, b) pair of each column's fin items.  Only
        # the strict a < b half is generated (item (k, a) spawns m_k − 1 − a
        # minor entries b = a+1..m_k−1); the mirrored (b, a) half and the
        # diagonal (a, a) tuples are derived arithmetically — a pair and its
        # mirror share one L slot index ``t`` (rows are sorted within a
        # column, so a < b ⇔ Li[a] < Li[b]: the (a, b) tuple hits the
        # mirror-U slot n+nnzL+t, the (b, a) tuple the L slot n+t, the
        # diagonal the pivot slot).
        kt = np.int32 if n <= 46340 else np.int64          # n² within int32?
        lk32 = lkeys.astype(kt) if kt is np.int32 else lkeys
        a_loc = np.arange(F, dtype=np.int64) - mex[cid]  # a within its column
        len1 = np.repeat(m, m) - 1 - a_loc         # strict pairs per item
        T1 = int(len1.sum())
        gex1 = np.concatenate([[0], np.cumsum(len1)])[:-1]
        jidx = np.repeat(lidx + 1 - gex1, len1) \
            + np.arange(T1, dtype=np.int64)                # Lptr[col] + b
        jj = Li32[jidx]
        ii = np.repeat(rows, len1)                 # Li[base + a], ii < jj
        pa = np.repeat(finl, len1)                         # base + a
        pb = (jidx + n).astype(np.int32)                   # base + b
        lk = ii.astype(kt) * kt(n) + jj
        t = np.searchsorted(lk32, lk)
        if incomplete:                                     # ILU(0): drop fill
            tc = np.minimum(t, max(nnzL - 1, 0))
            keep = (lkeys[tc] == lk) if nnzL else np.zeros_like(lk, bool)
            t = tc[keep].astype(np.int32)
            jj, ii, pa, pb = jj[keep], ii[keep], pa[keep], pb[keep]
            P = np.bincount(np.repeat(cid, len1)[keep], minlength=n)
        else:
            # closure guard: every strict pair of an etree-derived structure
            # must hit its exact L slot — a miss here must fail fast, not
            # scatter updates into a wrong (or scratch) slot
            tc = np.minimum(t, max(nnzL - 1, 0))
            assert not t.size or bool((lkeys[tc] == lk).all()), \
                "fill closure violated"
            t = tc.astype(np.int32)
            P = (m * (m - 1)) // 2                     # strict pairs/column
        n_pairs = t.size
    u = m + 2 * P                                      # diag + both halves
    kept_updates = int(m.sum() + 2 * n_pairs)
    uex = np.concatenate([[0], np.cumsum(u)])

    # ---- placement (per level, per-column scalars only) -------------------
    # barrier: a level's finalizes start strictly after any step holding
    # earlier levels' updates; a column's updates start no earlier than the
    # step of its last finalize (the scan body runs finalize-then-update,
    # so sharing that step is sound).  Greedy fixed-width packing resolves
    # to  d_i = max(d_{i-1}, f_i·wu − E_i)  over columns (running max),
    # column i's tuples then occupying slots [d_i + E_i, d_i + E_i + u_i).
    col_fs = np.zeros(n, dtype=np.int64)               # fin start slot/column
    col_us = np.zeros(n, dtype=np.int64)               # up start slot/column
    c_fin = 0
    c_up = 0
    for l in range(n_levels):
        s0, s1_ = lvl_ptr[l], lvl_ptr[l + 1]
        if s0 == s1_:
            continue
        Fl = int(mex[s1_] - mex[s0])
        if not Fl:
            continue
        start_f = max(c_fin, -(-c_up // wu) * wf)
        col_fs[s0:s1_] = start_f + (mex[s0:s1_] - mex[s0])
        c_fin = start_f + Fl
        ml = m[s0:s1_]
        f = np.where(ml > 0, (col_fs[s0:s1_] + ml - 1) // wf, 0)
        ul = u[s0:s1_]
        Kl = int(uex[s1_] - uex[s0])
        if not Kl:
            continue
        E = uex[s0:s1_] - uex[s0]
        g = np.where(ul > 0, f * np.int64(wu) - E, 0)
        d = np.maximum.accumulate(np.concatenate([[c_up], g]))[1:]
        col_us[s0:s1_] = d + E
        c_up = int(d[-1] + E[-1] + ul[-1])

    fS = max(-(-c_fin // wf), -(-c_up // wu))
    if not (emit or incomplete):
        return None, fS, kept_updates

    # column k's slot block [col_us[k], col_us[k] + u_k) is laid out as
    # [diag tuples | (a, b) half | mirrored (b, a) half], each group
    # column-contiguous, so positions are repeats of per-column bases
    fin_pos = np.repeat(col_fs, m) + a_loc
    pos0 = np.repeat(col_us, m) + a_loc
    Pex = np.concatenate([[0], np.cumsum(P)])[:-1]
    pos1 = np.repeat(col_us + m - Pex, P) + np.arange(t.size, dtype=np.int64)
    pos2 = pos1 + np.repeat(P, P)
    nn = np.int32(nnzL)

    def grid(width, pad, writes):
        out = np.empty(fS * width, dtype=np.int32)
        out.fill(pad)
        for p, v in writes:
            out[p] = v
        return out.reshape(fS, width)

    factor = PackedFactor(
        fin_lpos=np.asarray(grid(wf, szero, [(fin_pos, finl)])),
        fin_piv=np.asarray(grid(wf, sone, [(fin_pos, finp)])),
        up_s1=np.asarray(grid(wu, szero, [(pos0, finl), (pos1, pa),
                                           (pos2, pb)])),
        up_s2=np.asarray(grid(wu, szero, [(pos0, finl + nn), (pos1, pb + nn),
                                           (pos2, pa + nn)])),
        up_dst=np.asarray(grid(wu, szero, [(pos0, rows),
                                            (pos1, np.int32(n) + nn + t),
                                            (pos2, np.int32(n) + t)])))
    return factor, fS, kept_updates


def _emit_sweep(n: int, nnzL: int, tgt: np.ndarray, src: np.ndarray,
                level: np.ndarray, n_levels: int,
                descending: bool) -> PackedSweep:
    """Packed program for one triangular-sweep direction (vectorized).

    Entries are grouped by the level of their *target* node (ascending for
    the row program, descending for the col program); within a level, a
    node's divide shares (or follows) the step of its last incoming add,
    and adds of different levels never share a step (the next level's floor
    is one past the last divide).  Same prefix-sum/cummax placement as the
    factorization program, two streams: adds (width ~ mean entries/level)
    and divides (width ~ mean nodes/level).
    """
    szero = n + 2 * nnzL
    sone = szero + 1
    we = _width(nnzL, n_levels)
    wd = _width(n, n_levels)

    gpos = level[tgt]
    npos = level
    if descending:
        gpos = (n_levels - 1) - gpos
        npos = (n_levels - 1) - npos
    eorder = np.lexsort((np.arange(nnzL), tgt, gpos))
    ecnt = np.bincount(gpos, minlength=n_levels)
    eptr = np.concatenate([[0], np.cumsum(ecnt)])
    norder = np.lexsort((np.arange(n), npos))
    ncnt = np.bincount(npos, minlength=n_levels)
    nptr = np.concatenate([[0], np.cumsum(ncnt)])

    c_e = 0
    c_d = 0
    floor = 0
    e_pos: List[np.ndarray] = []
    e_ent: List[np.ndarray] = []
    d_pos: List[np.ndarray] = []
    d_val: List[np.ndarray] = []
    for l in range(n_levels):
        vs = norder[nptr[l]:nptr[l + 1]]
        ets = eorder[eptr[l]:eptr[l + 1]]
        if not vs.size:
            assert not ets.size, "sweep entry without its target node?"
            floor += 1
            continue
        Q = ets.size
        if Q:
            start_e = max(c_e, floor * we)
            e_pos.append(start_e + np.arange(Q, dtype=np.int64))
            e_ent.append(ets)
            # per-node entry counts (entries sorted by target within level)
            tv = tgt[ets]
            q = (np.searchsorted(tv, vs, side="right")
                 - np.searchsorted(tv, vs, side="left"))
            assert int(q.sum()) == Q, "sweep entry without its target node?"
            cq = np.cumsum(q)
            f = np.where(q > 0, (start_e + cq - 1) // we, floor)
            c_e = start_e + Q
        else:
            f = np.full(vs.size, floor, dtype=np.int64)
        # one divide per node, floored at its last incoming add
        g = f * np.int64(wd) - np.arange(vs.size, dtype=np.int64)
        d = np.maximum.accumulate(np.concatenate([[c_d], g]))[1:]
        pos = d + np.arange(vs.size, dtype=np.int64)
        d_pos.append(pos)
        d_val.append(vs)
        c_d = int(pos[-1]) + 1
        floor = (c_d - 1) // wd + 1            # next level strictly after

    S = max(-(-c_e // we), -(-c_d // wd))

    def grid(pos_list, val_list, width, pad):
        out = np.empty(S * width, dtype=np.int32)
        out.fill(pad)
        if pos_list:
            out[np.concatenate(pos_list)] = np.concatenate(val_list)
        return out.reshape(S, width)

    ents = (np.concatenate(e_ent) if e_ent else np.empty(0, np.int64))
    epos = e_pos
    return PackedSweep(
        tgt=np.asarray(grid(epos, [tgt[ents]], we, n), np.int32),
        src=np.asarray(grid(epos, [src[ents]], we, n), np.int32),
        lpos=np.asarray(grid(epos, [n + ents], we, szero), np.int32),
        upos=np.asarray(grid(epos, [n + nnzL + ents], we, szero), np.int32),
        dn=np.asarray(grid(d_pos, d_val, wd, n), np.int32),
        dpiv=np.asarray(grid(d_pos, d_val, wd, sone), np.int32))

# ---------------------------------------------------------------------------
# supernodal analysis (fundamental chains -> dense-panel program)
# ---------------------------------------------------------------------------

def _supernode_partition(parent: np.ndarray, counts: np.ndarray,
                         max_w: int) -> np.ndarray:
    """Fundamental supernodes of the filled pattern, width-capped.

    Column ``j+1`` extends column ``j``'s supernode iff ``parent[j] == j+1``
    and ``counts[j+1] == counts[j] - 1`` — by the etree subset property this
    forces ``struct(j) = {j+1} ∪ struct(j+1)``, i.e. a dense trapezoidal
    panel.  AMD's hash-merged supervariables are expanded adjacently, so they
    land in one chain for free.  Returns supernode boundaries ``sptr``
    (ns+1,) with runs capped at ``max_w`` columns.
    """
    n = counts.size
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    chain = np.zeros(n, dtype=bool)
    if n > 1:
        j = np.arange(n - 1, dtype=np.int64)
        chain[1:] = (parent[:-1] == j + 1) & (counts[1:] == counts[:-1] - 1)
    starts = [0]
    w = 1
    for jj in range(1, n):
        if chain[jj] and w < max_w:
            w += 1
        else:
            starts.append(jj)
            w = 1
    starts.append(n)
    return np.asarray(starts, dtype=np.int64)


def _amalgamate_pairs(n: int, Ri: np.ndarray, Rj: np.ndarray,
                      parent: np.ndarray, Li: np.ndarray, Lptr: np.ndarray,
                      sptr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Relaxed amalgamation: pad singleton etree-chain columns so they merge
    into pairable supernodes (the static Bunch–Kaufman prerequisite).

    A width-1 supernode {j} with ``parent[j] == j+1`` (e.g. the sibling-leaf
    chains AMD emits around indefinite saddle blocks) is padded to
    ``struct(j) := {j+1} ∪ struct(j+1)`` — a pure superset by the etree
    property, so fill closure and the level schedule stay valid — which makes
    the fundamental-chain condition hold and fuses {j} with the following
    supernode on re-partition.  Merges never chain: a merge target is
    consumed and cannot initiate its own merge (left-to-right scan), keeping
    the extra fill at one struct-union per pair instead of densifying
    tridiagonal-like patterns.  Returns (possibly padded) (Ri, Rj).
    """
    w = np.diff(sptr)
    pad_i: List[np.ndarray] = []
    pad_j: List[np.ndarray] = []
    consumed = False
    for s in range(w.size - 1):
        if consumed:                    # this snode is a merge target
            consumed = False
            continue
        j = int(sptr[s])
        if w[s] != 1 or parent[j] != j + 1:
            continue
        cur = Li[Lptr[j]:Lptr[j + 1]]
        nxt = Li[Lptr[j + 1]:Lptr[j + 2]]
        target = np.union1d(nxt, np.asarray([j + 1], dtype=np.int64))
        assert np.setdiff1d(cur, target).size == 0, \
            "etree subset property violated in amalgamation"
        extra = np.setdiff1d(target, cur)
        if extra.size:
            pad_i.append(extra.astype(np.int64))
            pad_j.append(np.full(extra.size, j, dtype=np.int64))
        consumed = True
    if not pad_i:
        return Ri, Rj
    return (np.concatenate([Ri] + pad_i), np.concatenate([Rj] + pad_j))


def _sn_slots(ri, cj, n: int, nnzL: int, lkeys: np.ndarray, valid):
    """Vectorized C-slot lookup for supernode index grids.

    Entry (ri, cj): the pivot slot on the diagonal, the column-major L slot
    below it, the mirror-U slot above it; invalid (pad) entries land on the
    scratch sink.  Asserts fill closure for every valid off-diagonal entry.
    """
    ri = ri.astype(np.int64)
    cj = cj.astype(np.int64)
    key = np.where(ri > cj, cj * n + ri, ri * n + cj)
    t = np.searchsorted(lkeys, key)
    tc = np.minimum(t, max(nnzL - 1, 0))
    ok = (lkeys[tc] == key) if nnzL else np.zeros(key.shape, dtype=bool)
    assert bool((ok | ~valid | (ri == cj)).all()), \
        "supernode slot closure violated"
    slot = np.where(ri == cj, ri,
                    np.where(ri > cj, n + tc, n + nnzL + tc))
    return np.where(valid, slot, n + 2 * nnzL).astype(np.int32)


def _pow2(x: np.ndarray, lo: int) -> np.ndarray:
    v = np.maximum(np.asarray(x, dtype=np.int64), lo)
    out = np.ones_like(v)
    while True:
        mask = out < v
        if not mask.any():
            return out
        out = np.where(mask, out * 2, out)


def _emit_snode(n: int, nnzL: int, Li: np.ndarray, Lptr: np.ndarray,
                Ljc: np.ndarray, counts: np.ndarray, lkeys: np.ndarray,
                sptr: np.ndarray, want_pairs: bool,
                mode: str) -> Optional[SnodeProgram]:
    """Emit the supernodal panel program (or None when ``mode="auto"``
    declines — narrow chains / deep schedules where the scalar scan wins).

    Supernodes are scheduled by assembly-tree level (longest path over
    cross-supernode L edges — every edge source has the smaller supernode id,
    so one ascending pass computes levels), then bucketed by padded panel
    shape (pow2 width/sub-row counts, pow2 lane counts) so the number of
    distinct compiled panel kernels is logarithmic in problem size.
    """
    ns = sptr.size - 1
    if ns == 0:
        return None
    c0 = sptr[:-1]
    c1 = sptr[1:]
    w = c1 - c0
    r = counts[c1 - 1]
    assert bool((counts[c0] == w - 1 + r).all()), \
        "fundamental supernode chain violated"
    mean_w = float(n) / float(ns)
    col2s = np.repeat(np.arange(ns, dtype=np.int64), w)

    # assembly-tree levels over cross-supernode dependencies
    es = col2s[Ljc]
    ed = col2s[Li]
    msk = es != ed
    es, ed = es[msk], ed[msk]
    eo = np.argsort(ed, kind="stable")
    es, ed = es[eo], ed[eo]
    eptr = np.searchsorted(ed, np.arange(ns + 1, dtype=np.int64))
    slev = np.zeros(ns, dtype=np.int64)
    for s in range(ns):
        lo, hi = eptr[s], eptr[s + 1]
        if hi > lo:
            slev[s] = int(slev[es[lo:hi]].max()) + 1

    wb_of = _pow2(w, 2)
    rb_of = _pow2(r, 4)
    groups: dict = {}
    for s in range(ns):
        groups.setdefault(
            (int(slev[s]), int(wb_of[s]), int(rb_of[s])), []).append(s)
    n_groups = len(groups)
    nnz_sn = w * r + (w * (w - 1)) // 2
    panel_fraction = (float(nnz_sn[w >= 2].sum()) / float(max(nnzL, 1)))
    stats = {"n_snodes": int(ns), "mean_snode_width": mean_w,
             "panel_fraction": panel_fraction, "n_groups": n_groups,
             "n_slevels": int(slev.max()) + 1 if ns else 0}

    if mode == "auto" and not want_pairs:
        # the panel path pays off when each bucketed kernel launch batches
        # many supernode lanes (level-parallel elimination) — narrow snodes
        # are fine (2-D Poisson averages ~1.3 and still wins 3-4x on the
        # lane batching alone), but a sequential chain — e.g. a tridiagonal,
        # where every snode is its own level with one lane — would serialize
        # n tiny kernel launches and lose to the scalar scan
        lanes_per_group = float(ns) / float(max(n_groups, 1))
        if n < 512 or lanes_per_group < 4.0 or n_groups > 4096:
            return None

    nlev = int(slev.max()) + 1 if ns else 1
    by_level: List[List[SnodeBucket]] = [[] for _ in range(nlev)]
    pair_p1: List[np.ndarray] = []
    for (lv, wb, rb), members in sorted(groups.items()):
        idx = np.asarray(members, dtype=np.int64)
        k = idx.size
        kp = 1 << max(int(k - 1).bit_length(), 0)   # pow2 lanes, pads no-op
        c0g = c0[idx]
        wg = w[idx]
        rg = r[idx]
        aw = np.arange(wb, dtype=np.int64)
        ar = np.arange(rb, dtype=np.int64)
        tw = aw[None, :] < wg[:, None]
        ta = ar[None, :] < rg[:, None]
        rows_blk = np.where(tw, c0g[:, None] + aw[None, :], n)
        pstart = Lptr[c1[idx] - 1]
        gidx = np.minimum(pstart[:, None] + ar[None, :], max(nnzL - 1, 0))
        # (a pattern with no off-diagonal fill, e.g. the diagonal coarsest
        # level of a stalled AMG aggregation, has an empty Li)
        rows_sub = np.where(ta, Li[gidx], n) if nnzL else \
            np.full_like(gidx, n)
        rows = np.concatenate([rows_blk, rows_sub], axis=1)   # (k, wb+rb)
        cjs = c0g[:, None] + aw[None, :]                      # (k, wb)
        vP = (rows < n)[:, :, None] & tw[:, None, :]
        pidx = _sn_slots(rows[:, :, None], cjs[:, None, :], n, nnzL,
                         lkeys, vP)
        vQ = tw[:, :, None] & ta[:, None, :]
        qidx = _sn_slots(cjs[:, :, None], rows_sub[:, None, :], n, nnzL,
                         lkeys, vQ)
        vU = ta[:, :, None] & ta[:, None, :]
        uidx = _sn_slots(rows_sub[:, :, None], rows_sub[:, None, :], n, nnzL,
                         lkeys, vU)
        if want_pairs:
            bkm = tw & (aw[None, :] % 2 == 0) & (aw[None, :] + 1 < wg[:, None])
            for l in range(k):
                offs = np.arange(0, int(wg[l]) - 1, 2, dtype=np.int64)
                if offs.size:
                    pair_p1.append(c0g[l] + offs)
        else:
            bkm = np.zeros((k, wb), dtype=bool)
        if kp > k:                                            # pad lanes
            pad = kp - k

            def lanepad(arr, fill):
                ext = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
                return np.concatenate([arr, ext], axis=0)

            szero = np.int32(n + 2 * nnzL)
            pidx = lanepad(pidx, szero)
            qidx = lanepad(qidx, szero)
            uidx = lanepad(uidx, szero)
            rows = lanepad(rows, n)
            wg = lanepad(wg, 0)
            rg = lanepad(rg, 0)
            bkm = lanepad(bkm, False)
        by_level[lv].append(SnodeBucket(
            wb=int(wb), rb=int(rb), pairs=bool(want_pairs and bkm.any()),
            pidx=np.asarray(pidx), qidx=np.asarray(qidx),
            uidx=np.asarray(uidx),
            rows=np.asarray(rows.astype(np.int32)),
            wvec=np.asarray(wg.astype(np.int32)),
            rvec=np.asarray(rg.astype(np.int32)),
            bkm=np.asarray(bkm)))

    if pair_p1:
        p1 = np.sort(np.concatenate(pair_p1))
        key = p1 * np.int64(n) + (p1 + 1)          # L(t+1, t), col-major key
        t = np.searchsorted(lkeys, key)
        tc = np.minimum(t, max(nnzL - 1, 0))
        assert bool((lkeys[tc] == key).all()), \
            "pair pivot off the fundamental chain"
        pair_cols = np.stack([p1, p1 + 1], axis=1)
        pair_off = np.stack([n + nnzL + tc, n + tc], axis=1)   # (b, c) slots
        unpaired = np.ones(n, dtype=bool)
        unpaired[p1] = False
        unpaired[p1 + 1] = False
    else:
        pair_cols = np.zeros((0, 2), dtype=np.int64)
        pair_off = np.zeros((0, 2), dtype=np.int64)
        unpaired = np.ones(n, dtype=bool)
    stats["n_pair_pivots"] = int(pair_cols.shape[0])
    return SnodeProgram(
        schedule=tuple(tuple(b) for b in by_level),
        pair_cols=np.asarray(pair_cols.astype(np.int32)),
        pair_off=np.asarray(pair_off.astype(np.int32)),
        unpaired=np.asarray(unpaired),
        stats=stats)


def symbolic_factor(row, col, n: int, *, ordering: str = "amd",
                    incomplete: bool = False,
                    supernodal: Optional[str] = None,
                    pivot_blocks: Optional[str] = None) -> DirectArtifacts:
    """Analyze one sparsity pattern for direct (or incomplete) factorization.

    This is the plan engine's ``analyze`` stage: values-free, eager numpy,
    run ONCE per sparsity pattern and shared by every ``with_values``
    refresh, every shared-pattern batch element, the adjoint's transposed
    solves, ``precond="ilu"``, the AMG coarsest level, and ``slogdet``.

    Parameters
    ----------
    row, col : integer index arrays (COO, concrete — never tracers).
    n : matrix dimension.
    ordering : fill-reducing ordering of the symmetrized pattern graph.

        - ``"amd"`` (default) — approximate minimum degree on a quotient
          graph (:func:`_amd_order`): element absorption, hash-based
          supervariable detection, aggressive absorption and mass
          elimination.  Near-MD fill quality at a fraction of the analyze
          cost; the whole pipeline is ~15–20× faster than ``"md"`` at
          n = 10⁴.
        - ``"md"`` — exact minimum degree (clique-forming elimination),
          retained for A/B fill-quality comparisons.
        - ``"rcm"`` — reverse Cuthill–McKee (scipy when available,
          identity fallback otherwise).
        - ``"natural"`` — identity permutation.
    incomplete : ``True`` produces the ILU(0)/IC(0) program — same storage
        and kernels, zero fill (update tuples restricted to the original
        symmetrized pattern), no elimination tree needed.  Degree-based
        orderings are pointless at zero fill, so ``"amd"``/``"md"`` resolve
        to ``"natural"`` (ILU(0) keeps the assembly order).  The supernodal
        program needs the etree, so incomplete factorizations always stay on
        the scalar path.
    supernodal : ``"auto"``/``"on"``/``"off"`` — emit the dense-panel
        supernodal program instead of the scalar one (``numeric_factor``
        and ``factored_solve`` route through it when present).  ``None``
        (default) reads the :mod:`repro_torch.core.options` ``supernodal``
        knob at analyze time.  ``"auto"`` declines narrow-chain patterns where the
        scalar scan wins; ``"off"`` is the A/B baseline.
    pivot_blocks : ``"auto"`` requests static Bunch–Kaufman 2x2 pivot blocks
        chosen at analyze time: singleton etree-chain columns are
        amalgamated into pairable supernodes and every supernode's even
        column offsets start a 2x2 pivot, eliminated jointly at numeric
        time — indefinite (saddle-point) systems factor without the
        zero-pivot perturbation stopgap.  Requires the supernodal path
        (``supernodal="off"`` raises); ``None`` keeps plain 1x1 pivots.

    Raises ``ValueError`` when the pattern lacks a structurally full
    diagonal (no pivoting is performed, so every pivot must exist
    structurally; see ``numeric_factor``'s ``pivot_guard`` for the
    *numerically* zero case).

    Returns numpy artifacts; :func:`to_device` places them on a device.
    """
    return _symbolic_factor(row, col, n, ordering, incomplete, supernodal,
                            pivot_blocks)


def _symbolic_factor(row, col, n: int, ordering: str, incomplete: bool,
                     supernodal: Optional[str] = None,
                     pivot_blocks: Optional[str] = None) -> DirectArtifacts:
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    from .sparse import has_full_diagonal
    if not has_full_diagonal(row, col, n):
        raise ValueError(
            "direct factorization needs a structurally full diagonal "
            "(no pivoting); use an iterative backend for this pattern")

    if supernodal is None:
        from . import options as _options
        supernodal = _options.current().supernodal
    if supernodal not in ("auto", "on", "off"):
        raise ValueError(
            f"supernodal must be 'auto'|'on'|'off', got {supernodal!r}")
    if pivot_blocks not in (None, "auto"):
        raise ValueError(
            f"pivot_blocks must be None or 'auto', got {pivot_blocks!r}")
    want_pairs = pivot_blocks == "auto"
    if incomplete:
        if want_pairs:
            raise ValueError(
                "pivot_blocks needs the full (etree) factorization; "
                "incomplete=True has no pivoting")
        supernodal = "off"          # ILU(0) has no etree — scalar program
    if want_pairs and supernodal == "off":
        raise ValueError(
            "pivot_blocks='auto' requires the supernodal path "
            "(supernodal='off' keeps the scalar 1x1-pivot program)")

    if incomplete and ordering in ("amd", "md"):
        ordering = "natural"        # ILU(0) keeps the assembly order
    if ordering == "amd":
        perm = _amd_order(row, col, n)
    elif ordering == "md":
        perm = _exact_md_order(row, col, n)
    elif ordering == "rcm":
        perm = _rcm_order(row, col, n)
    elif ordering == "natural":
        perm = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown ordering {ordering!r}")
    ipos = np.empty(n, dtype=np.int64)
    ipos[perm] = np.arange(n)

    # strict-lower symmetrized pattern in permuted coordinates, CSR by row
    rptr, rcol = _sym_lower_csr(row, col, n, ipos)
    if incomplete:                  # zero fill: the L structure IS the pattern
        Ri, Rj = np.repeat(np.arange(n, dtype=np.int64),
                           np.diff(rptr)), rcol
        level = _pattern_levels(n, rptr, rcol)
        parent = None
    else:                           # etree pass: fill without the filled graph
        Ri, Rj, level, parent = _etree_fill(n, rptr, rcol)
    n_levels = int(level.max()) + 1 if n else 1

    # L pattern, column-major: column k holds sorted permuted row indices.
    corder = np.lexsort((Ri, Rj))
    Li = Ri[corder]
    counts = np.bincount(Rj, minlength=n).astype(np.int64)
    Lptr = np.concatenate([[0], np.cumsum(counts)])

    # supernode partition (+ Bunch–Kaufman pair amalgamation, which pads the
    # pattern — a superset, so ``level`` stays a valid schedule and every
    # closure assert below still holds)
    sptr = None
    if parent is not None and supernodal != "off" and n:
        sptr = _supernode_partition(parent, counts, SN_MAX_W)
        if want_pairs:
            Ri2, Rj2 = _amalgamate_pairs(n, Ri, Rj, parent, Li, Lptr, sptr)
            if Ri2 is not Ri:
                Ri, Rj = Ri2, Rj2
                corder = np.lexsort((Ri, Rj))
                Li = Ri[corder]
                counts = np.bincount(Rj, minlength=n).astype(np.int64)
                Lptr = np.concatenate([[0], np.cumsum(counts)])
            sptr = _supernode_partition(parent, counts, SN_MAX_W)
    nnzL = int(Lptr[-1])
    nnzF = n + 2 * nnzL
    lkeys = Rj[corder] * np.int64(n) + Li      # sorted: position lookup in L

    # scatter map for A's entries into F = diag ∪ L ∪ mirror(U)
    pi, pj = ipos[row], ipos[col]
    ak = np.minimum(pi, pj) * np.int64(n) + np.maximum(pi, pj)
    at = np.searchsorted(lkeys, ak)
    at = np.minimum(at, max(nnzL - 1, 0))
    aok = (lkeys[at] == ak) if nnzL else np.zeros_like(ak, bool)
    diag = pi == pj
    assert bool((aok | diag).all()), \
        "A entry outside its own symmetrized pattern?"
    a2f = np.where(diag, pi, np.where(pi > pj, n + at, n + nnzL + at))

    # the supernodal program first: where it is emitted, the scalar packed
    # program would never run, so only its step and update counts are made
    Ljc = Rj[corder]
    snode = None
    if sptr is not None:
        snode = _emit_snode(n, nnzL, Li, Lptr, Ljc, counts, lkeys, sptr,
                            want_pairs, supernodal)
    scalar = snode is None
    factor, fS, kept_updates = _emit_factor(
        n, nnzL, Li, Lptr, counts, level, n_levels, lkeys, incomplete,
        emit=scalar)

    # row program (levels leaf→root): forward-L and transposed-Uᵀ sweeps;
    # col program (root→leaf): backward-U and transposed-Lᵀ sweeps.
    row_sweep = col_sweep = None
    if scalar:
        row_sweep = _emit_sweep(n, nnzL, Li, Ljc, level, n_levels,
                                descending=False)
        col_sweep = _emit_sweep(n, nnzL, Ljc, Li, level, n_levels,
                                descending=True)

    stats = {"nnz_L": nnzL, "n_levels": n_levels, "flops": kept_updates,
             "fill_ratio": float(nnzF) / float(max(len(row), 1)),
             "n_steps": fS, "ordering": ordering, "incomplete": incomplete,
             "supernodal": snode is not None}
    if snode is not None:
        stats.update(snode.stats)
    return DirectArtifacts(
        n=n, nnzF=nnzF,
        perm=np.asarray(perm, np.int32), ipos=np.asarray(ipos, np.int32),
        a2f=np.asarray(a2f, np.int32),
        factor=factor, row_sweep=row_sweep, col_sweep=col_sweep, stats=stats,
        snode=snode)


# ---------------------------------------------------------------------------
# device placement (once per pattern, at analyze time)
# ---------------------------------------------------------------------------

def _on(a, device, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def _program_on(p, device):
    return None if p is None else type(p)(*[_on(a, device) for a in p])


def _live_targets(bk: SnodeBucket) -> Tuple[np.ndarray, np.ndarray]:
    """The extend-add targets of a (numpy) bucket without their pads: lane
    l's r_l × r_l block of ``uidx``, row-major, lanes concatenated, and the
    (k+1,) lane offsets."""
    from ..kernels.ref import sn_target_mask
    r = bk.rvec.astype(np.int64)
    live = sn_target_mask(torch.from_numpy(r), bk.rb, "cpu").numpy()
    return (np.ascontiguousarray(bk.uidx[live], dtype=np.int32),
            np.concatenate([[0], np.cumsum(r * r)]))


def _bucket_on(bk: SnodeBucket, device) -> SnodeBucket:
    from ..kernels.supernode import check_sweep_bucket
    tgt, uoff = _live_targets(bk)
    i32 = torch.int32
    out = bk._replace(
        pidx=_on(bk.pidx, device, i32), qidx=_on(bk.qidx, device, i32),
        uidx=_on(tgt, device, i32), uoff=_on(uoff, device),
        rows=_on(bk.rows, device, i32),
        wvec=_on(bk.wvec, device, i32), rvec=_on(bk.rvec, device, i32),
        bkm=_on(bk.bkm, device, torch.bool))
    check_sweep_bucket(out, device)
    return out


def to_device(art: DirectArtifacts, device) -> DirectArtifacts:
    """The artifacts with every array on ``device`` — done once per pattern
    at analyze time, never per factorization or solve.  The panel kernels'
    slot tables (``pidx``, ``qidx``) and the sweep's row ids (``rows``)
    become int32 and ``uidx`` the live-only int32 target table with its
    int64 lane offsets ``uoff`` (:func:`_live_targets`; every slot of ``C``
    fits in int32), ``wvec``/``rvec`` int32 and ``bkm`` bool, checked once
    here for the sweep kernel; the other index arrays int64 (the type torch
    indexing takes)."""
    device = torch.device(device)
    sn = art.snode
    if sn is not None:
        if art.nnzF + 2 > np.iinfo(np.int32).max:
            raise ValueError(f"direct: {art.nnzF + 2} factor slots exceed "
                             f"the panel kernels' int32 slot indices")
        sn = sn._replace(
            schedule=tuple(tuple(_bucket_on(bk, device) for bk in lvl)
                           for lvl in sn.schedule),
            pair_cols=_on(sn.pair_cols, device),
            pair_off=_on(sn.pair_off, device),
            unpaired=_on(sn.unpaired, device, torch.bool), buffers={})
    return art._replace(
        perm=_on(art.perm, device), ipos=_on(art.ipos, device),
        a2f=_on(art.a2f, device),
        factor=_program_on(art.factor, device),
        row_sweep=_program_on(art.row_sweep, device),
        col_sweep=_program_on(art.col_sweep, device), snode=sn)


# ---------------------------------------------------------------------------
# numeric factorization (the setup stage)
# ---------------------------------------------------------------------------

def _pivot_tau(val: torch.Tensor, pivot_eps: Optional[float]) -> torch.Tensor:
    if pivot_eps is not None:
        return torch.tensor(pivot_eps, dtype=val.dtype, device=val.device)
    eps = torch.tensor(torch.finfo(val.dtype).eps, dtype=val.dtype,
                       device=val.device)
    return torch.sqrt(eps) * torch.clamp_min(val.abs().max(), 1e-300)


def _warn_perturbed(n_bad: int, tau: float) -> None:
    warnings.warn(
        f"numeric factorization hit {n_bad} numerically-zero "
        f"pivot(s); applied a scaled diagonal perturbation "
        f"(|d|<{tau:.2e} -> ±{tau:.2e}). The "
        f"factors solve a nearby matrix — consider an iterative "
        f"backend or a symmetric shift for indefinite systems.")


def _snode_numeric(art: DirectArtifacts, C: torch.Tensor, tau, guard: bool):
    """The supernodal factorization schedule over the assembled C, level by
    level, two kernels per bucket, both in place in C: ``panel_factor``,
    then ``schur_update`` into the ancestors' slots.  Within a level this is
    sound: a bucket's lanes own disjoint columns, and its extend-add targets
    lie in ancestors, which are on higher levels.  Pad slots all name the
    scratch sink, which is read masked and never written.  Returns (C, nbad)
    with nbad a device scalar."""
    from ..kernels import supernode as ksn
    nbad = torch.zeros((), dtype=C.dtype, device=C.device)
    k_max = max(bk.wvec.shape[0] for lvl in art.snode.schedule for bk in lvl)
    work = torch.zeros(k_max, dtype=torch.int32, device=C.device)
    for lvl in art.snode.schedule:
        for bk in lvl:
            ksn.panel_factor_inplace(C, bk.pidx, bk.qidx, bk.wvec, bk.rvec,
                                     tau, bk.bkm, pairs=bk.pairs, guard=guard,
                                     nbad=nbad, work=work)
            ksn.schur_update_inplace(C, bk.pidx, bk.qidx, bk.wvec, bk.rvec,
                                     bk.uidx, bk.uoff)
    return C, nbad


def _scalar_numeric(art: DirectArtifacts, C: torch.Tensor, tau, guard: bool):
    """The scalar packed scan, one Python iteration per step.  With the
    guard, every pivot with |d| < τ is replaced by ±τ in storage before its
    divide; the count of perturbed pivots comes back as a device scalar."""
    f = art.factor
    pert = torch.zeros(art.nnzF + 2, dtype=torch.bool, device=C.device) \
        if guard else None
    for s in range(f.fin_lpos.shape[0]):
        fl, fpv = f.fin_lpos[s], f.fin_piv[s]
        if guard:
            piv = C[fpv]
            bad = piv.abs() < tau            # pads divide by scratch 1.0
            C[fpv] = torch.where(bad, torch.where(piv >= 0, tau, -tau), piv)
            pert[fpv] = pert[fpv] | bad
        C[fl] = C[fl] / C[fpv]
        C.index_add_(0, f.up_dst[s], C[f.up_s1[s]] * C[f.up_s2[s]],
                     alpha=-1)
    return C, (pert[:art.n].sum() if guard else None)


def numeric_factor(art: DirectArtifacts, val: torch.Tensor, *,
                   pivot_guard: bool = True,
                   pivot_eps: Optional[float] = None) -> torch.Tensor:
    """Numeric LU/LDLᵀ over the precomputed fill pattern (``art`` from
    :func:`to_device`, on ``val``'s device).  Duplicate COO entries
    accumulate.

    ``pivot_guard`` (default on): no numerical pivoting is performed, so a
    structurally present but numerically (near-)zero pivot would turn the
    factors into NaNs.  The guard replaces any pivot with |d| < τ
    (τ = ``pivot_eps`` or √eps·max|A|) by ±τ in storage, so the sweeps
    stay consistent, and warns once with the count (one host read per
    factorization).  Runs without autograd: gradients come from the adjoint
    functions, not through the factorization."""
    with torch.no_grad():
        val = val.detach()
        tau = _pivot_tau(val, pivot_eps)
        C = torch.zeros(art.nnzF + 2, dtype=val.dtype, device=val.device)
        C.index_add_(0, art.a2f, val)
        C[art.nnzF + 1] = 1.0
        if art.snode is not None:
            C, nbad = _snode_numeric(art, C, tau, pivot_guard)
        else:
            C, nbad = _scalar_numeric(art, C, tau, pivot_guard)
        if nbad is not None:
            n_bad = int(nbad)
            if n_bad:
                _warn_perturbed(n_bad, float(tau))
        return C


# ---------------------------------------------------------------------------
# triangular sweeps (the solve stage); y is (n+1, m), row n a scratch zero
# ---------------------------------------------------------------------------

def _sweep(C, y, program: PackedSweep, use_upos: bool, divide: bool):
    pos = program.upos if use_upos else program.lpos
    for s in range(program.tgt.shape[0]):
        y.index_add_(0, program.tgt[s],
                     -C[pos[s]].unsqueeze(1) * y[program.src[s]])
        if divide:
            dn = program.dn[s]
            y[dn] = y[dn] / C[program.dpiv[s]].unsqueeze(1)
    return y


def _sweep_buffers(sn: SnodeProgram, m: int, dtype, device):
    """The ``sn_sweep`` work / part buffers for up to m right-hand sides,
    made once per plan and dtype and grown with m (every launch leaves the
    counters at zero, so the next solve reuses them)."""
    from ..kernels import supernode as ksn
    have = sn.buffers.get(dtype)
    if have is None or have[0] < m:
        have = sn.buffers[dtype] = (m,) + ksn.sweep_buffers(
            [bk for lvl in sn.schedule for bk in lvl], m, dtype, device)
    return have[1:]


def _snode_solve(art: DirectArtifacts, C, y, transposed: bool):
    """Supernodal sweeps (forward or transposed) on the panel factors —
    ascending levels for L/Uᵀ, descending for U/Lᵀ — one ``sn_sweep``
    launch per bucket and sweep, in place in y.  Within a level this is
    sound: a bucket's lanes own disjoint block rows, and the rows they
    scatter into or gather from lie in ancestors, on higher levels."""
    from ..kernels import supernode as ksn
    sched = art.snode.schedule
    first, second = ("ut", "lt") if transposed else ("l", "u")
    work = part = None
    if y.device.type != "cpu":
        work, part = _sweep_buffers(art.snode, y.shape[1], C.dtype, y.device)
    for lvl in sched:
        for bk in lvl:
            ksn.sn_sweep_inplace(C, y, bk, first, work=work, part=part)
    for lvl in reversed(sched):
        for bk in lvl:
            ksn.sn_sweep_inplace(C, y, bk, second, work=work, part=part)
    return y


def factored_solve(art: DirectArtifacts, C: torch.Tensor, b: torch.Tensor,
                   *, transposed: bool = False) -> torch.Tensor:
    """x with A x = b (or Aᵀ x = b) from the factors ``C``; ``b`` is (n,)
    or (n, m) for m right-hand sides.

    Forward: permute, unit-L then U sweeps, unpermute.  Transposed: the SAME
    factors with Uᵀ then Lᵀ sweeps — the adjoint's zero-refactorize path.
    Supernodal factors route through the blocked panel sweeps."""
    with torch.no_grad():
        vec = b.dim() == 1
        B = b.detach().reshape(b.shape[0], -1)
        n = art.n
        y = B.new_empty(n + 1, B.shape[1])
        torch.index_select(B, 0, art.perm, out=y[:n])
        y[n] = 0.0
        if art.snode is not None:
            y = _snode_solve(art, C, y, transposed)
        else:
            first, second = ((art.row_sweep, True, True),
                             (art.col_sweep, False, False)) if transposed \
                else ((art.row_sweep, False, False),
                      (art.col_sweep, True, True))
            y = _sweep(C, y, *first)
            y[n] = 0.0
            y = _sweep(C, y, *second)
        x = y[art.ipos]
        return x[:, 0] if vec else x


def factor_slogdet(art: DirectArtifacts, C: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sign, log|det A|) from the factors — pivot-block aware: a static
    2x2 pair contributes its block determinant ``a·e − b·c`` (raw entries
    in the pivot slots and the pair's b/c slots), not ``a·e``."""
    n = art.n
    piv = C[:n]
    sn = art.snode
    if sn is None or sn.pair_cols.shape[0] == 0:
        return torch.prod(torch.sign(piv)), torch.sum(torch.log(piv.abs()))
    unp = sn.unpaired
    d = torch.where(unp, piv, 1.0)
    sign = torch.prod(torch.sign(d))
    logabs = torch.sum(torch.where(unp, torch.log(d.abs()), 0.0))
    a = piv[sn.pair_cols[:, 0]]
    e = piv[sn.pair_cols[:, 1]]
    det = a * e - C[sn.pair_off[:, 0]] * C[sn.pair_off[:, 1]]
    return (sign * torch.prod(torch.sign(det)),
            logabs + torch.sum(torch.log(det.abs())))
