"""Plain PyTorch versions of the hand-written CUDA kernels.

Each kernel wrapper in this package runs its plain version here when the
tensors it is given lie on the CPU; ``chip_smoke.py`` holds every kernel
against its plain version on the card.  The formulas are those of the
reference's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sparse import SELL_SLICE


def stencil5_ref(val5: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Variable-coefficient 5-point stencil apply.

    ``val5``: (5, nx, ny) signed coefficient planes ordered (C, N, S, W, E);
    ``x``: (nx, ny).  Out-of-domain neighbours read zero.

        y[i,j] = C·x[i,j] + N·x[i-1,j] + S·x[i+1,j] + W·x[i,j-1] + E·x[i,j+1]
    """
    xn = F.pad(x, (0, 0, 1, 0))[:-1, :]    # x[i-1, j]
    xs = F.pad(x, (0, 0, 0, 1))[1:, :]     # x[i+1, j]
    xw = F.pad(x, (1, 0, 0, 0))[:, :-1]    # x[i, j-1]
    xe = F.pad(x, (0, 1, 0, 0))[:, 1:]     # x[i, j+1]
    return (val5[0] * x + val5[1] * xn + val5[2] * xs
            + val5[3] * xw + val5[4] * xe)


def fused_cg_update_ref(x, r, p, s, dinv, alpha):
    xn = x + alpha * p
    rn = r - alpha * s
    zn = dinv * rn
    return xn, rn, zn, torch.sum(rn * zn), torch.sum(rn * rn)


def fused_cg_direction_ref(z, w, p, s, beta):
    return z + beta * p, w + beta * s, torch.sum(w * z)


def fused_cg_halfstep_ref(x, r, p, s, alpha):
    xn = x + alpha * p
    rn = r - alpha * s
    return xn, rn, torch.sum(rn * rn)


def fused_cheb_step_ref(x, dk, rk, c1, c2):
    dn = c1 * dk + c2 * rk
    return x + dn, dn


def fused_dots2_ref(u, v):
    return torch.sum(u * v), torch.sum(u * u)


def fused_bicg_p_ref(r, p, v, dinv, beta, omega, restart):
    restart = torch.as_tensor(restart, device=r.device)
    pn = torch.where(restart != 0, r, r + beta * (p - omega * v))
    return pn, dinv * pn


def fused_bicg_s_ref(r, v, dinv, alpha):
    sn = r - alpha * v
    return sn, dinv * sn


def fused_bicg_tail_ref(x, s, t, phat, shat, rhat, alpha, omega):
    xn = x + alpha * phat + omega * shat
    rn = s - omega * t
    return xn, rn, torch.sum(rhat * rn), torch.sum(rn * rn)


def bell_matvec_ref(bell_vals: torch.Tensor, block_cols: torch.Tensor,
                    x_pad: torch.Tensor, n: int) -> torch.Tensor:
    """Block-ELL SpMV.  ``bell_vals``: (n_rb, k, bm, bn) dense blocks;
    ``block_cols``: (n_rb, k) column-block ids; ``x_pad``: (m_pad,).
    Returns y (n,)."""
    n_rb, k, bm, bn = bell_vals.shape
    xb = x_pad.reshape(-1, bn)                       # (n_cb, bn)
    gathered = xb[block_cols.long()]                 # (n_rb, k, bn)
    y = torch.einsum("rkab,rkb->ra", bell_vals, gathered)
    return y.reshape(n_rb * bm)[:n]


def sell_matvec_ref(slice_ptr: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """Sliced-ELL SpMV (the kernel's plain version): a gather of x over the
    padded layout and a sum per row.  ``slice_ptr`` (n_slices + 1,),
    ``cols``/``vals`` (n_slots,) as in ``core.sparse.SellLayout``; returns
    the first ``n`` rows of y.  Padding slots hold value 0."""
    w = SELL_SLICE
    n_slices = slice_ptr.numel() - 1
    slot = torch.arange(vals.numel(), device=vals.device)
    slc = torch.repeat_interleave(torch.arange(n_slices, device=vals.device),
                                  slice_ptr[1:] - slice_ptr[:-1])
    row = slc * w + (slot - slice_ptr[slc]) % w
    y = torch.zeros(n_slices * w, dtype=vals.dtype, device=vals.device)
    y.index_add_(0, row, vals * x[cols.long()])
    return y[:n]


# ---------------------------------------------------------------------------
# Supernodal panel kernels (kernels/supernode.py)
#
# Lane-batched forms of the reference's single-lane bodies: a Python loop
# over the panel column t with tensor ops across the bucket's lanes (the
# torch form of ``vmap`` over ``fori_loop``).  The masking, the τ clamp, the
# pair-determinant floor and the per-element order of operations are the
# reference's.
#
# Lane layout (one supernode of bucket shape (wb, rb), true size (w, r)):
#   P (wb+rb, wb): rows 0..wb-1 the dense diagonal block D (strict lower = L,
#       diagonal = pivots, strict upper = U), rows wb.. the sub-diagonal
#       L panel over the supernode's row structure;
#   Q (wb, rb):    the U panel.
# Entries gathered from pad slots hold scratch garbage, so every function
# first masks rows/columns beyond (w, r) to zero and plants a unit diagonal
# on pad pivots, making pad lanes exact no-ops.
# ---------------------------------------------------------------------------


def sn_pair_det(a, b, c, e):
    """Clamped determinant of a static Bunch–Kaufman 2x2 pivot
    E = [[a, b], [c, e]] (elementwise over lanes): the floor is locally
    scaled, eps·max|E|² + tiny.  Returns (detc, bad)."""
    det = a * e - b * c
    fi = torch.finfo(det.dtype)
    scale = torch.maximum(torch.maximum(a.abs(), e.abs()),
                          torch.maximum(b.abs(), c.abs()))
    floor = fi.eps * scale * scale + fi.tiny
    bad = det.abs() < floor
    detc = torch.where(bad, torch.where(det < 0, -floor, floor), det)
    return detc, bad


def sn_live_masks(wvec, rvec, wb, rb, device):
    """Live entries of a bucket's panels: (pmask (k, wb+rb, wb), qmask
    (k, wb, rb)) — rows/columns within the true sizes (w, r)."""
    w = wvec.to(device).long()[:, None, None]
    r = rvec.to(device).long()[:, None, None]
    ri = torch.arange(wb + rb, device=device)[None, :, None]
    cj = torch.arange(wb, device=device)[None, None, :]
    pmask = torch.where(ri < wb, ri < w, (ri - wb) < r) & (cj < w)
    qa = torch.arange(wb, device=device)[None, :, None]
    qc = torch.arange(rb, device=device)[None, None, :]
    return pmask, (qa < w) & (qc < r)


def sn_panel_mask(P, Q, wvec, rvec):
    """Zero pad rows/cols of gathered (P, Q) lanes; unit pad diagonal."""
    k, m, wb = P.shape
    dev = P.device
    pmask, qmask = sn_live_masks(wvec, rvec, wb, Q.shape[2], dev)
    w = wvec.to(dev).long()[:, None, None]
    ri = torch.arange(m, device=dev)[None, :, None]
    cj = torch.arange(wb, device=dev)[None, None, :]
    P = torch.where(pmask, P, 0.0)
    P = P + torch.where((ri == cj) & (cj >= w), 1.0, 0.0).to(P.dtype)
    return P, torch.where(qmask, Q, 0.0)


def sn_block_mask(D, wvec):
    """Zero pad rows/cols of gathered diagonal blocks; unit pad diagonal."""
    wb = D.shape[1]
    dev = D.device
    w = wvec.to(dev).long()[:, None, None]
    ri = torch.arange(wb, device=dev)[None, :, None]
    cj = torch.arange(wb, device=dev)[None, None, :]
    D = torch.where((ri < w) & (cj < w), D, 0.0)
    return D + torch.where((ri == cj) & (ri >= w), 1.0, 0.0).to(D.dtype)


def sn_panel_factor_ref(P, Q, wvec, rvec, tau, bkm, *, pairs=False,
                        guard=True):
    """Dense right-looking factorization of a bucket of supernode panels.

    ``P`` (k, wb+rb, wb), ``Q`` (k, wb, rb), ``wvec``/``rvec`` (k,) true
    sizes, ``tau`` the 1x1 pivot clamp, ``bkm`` (k, wb) pair-start flags.
    L columns are divided by their pivot, U rows stay raw, clamped pivots
    persist; with ``pairs`` a flagged column t starts a 2x2 pivot (t, t+1)
    eliminated jointly through E⁻¹, its four entries stored raw.  Returns
    (P, Q, nbad) with nbad the number of clamped 1x1 pivots / 2x2 dets."""
    P, Q = sn_panel_mask(P, Q, wvec, rvec)
    k, m, wb = P.shape
    dev, dt = P.device, P.dtype
    tau = torch.as_tensor(tau, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    rows = torch.arange(m, device=dev)[None, :]
    cols = torch.arange(wb, device=dev)[None, :]
    bkm = bkm.to(dev).bool()
    nbad = torch.zeros(k, dtype=dt, device=dev)
    for t in range(wb):
        # -- 1x1 elimination (a unit divisor on pair members keeps the
        #    discarded branch finite) --
        d = P[:, t, t]
        if guard:
            bad1 = d.abs() < tau
            dc = torch.where(bad1, torch.where(d < 0, -tau, tau), d)
        else:
            bad1 = torch.zeros(k, dtype=torch.bool, device=dev)
            dc = d
        if pairs:
            start = bkm[:, t]
            second = bkm[:, max(t - 1, 0)] & (t > 0)
            deff = torch.where(start | second, one, dc)
        else:
            deff = dc
        colL = torch.where(rows > t, P[:, :, t] / deff[:, None], 0.0)
        urow = torch.where(cols > t, P[:, t, :], 0.0)
        P1 = P - colL[:, :, None] * urow[:, None, :]
        P1[:, :, t] = torch.where(rows > t, colL, P[:, :, t])
        P1[:, t, t] = dc
        Q1 = Q - colL[:, :wb, None] * Q[:, t, :][:, None, :]
        if not pairs:
            P, Q = P1, Q1
            nbad = nbad + bad1.to(dt)
            continue
        # -- 2x2 elimination for the pair (t, t+1); t1 is clamped so the
        #    branch stays in bounds when discarded at t = wb-1 --
        t1 = min(t + 1, wb - 1)
        a, b = P[:, t, t], P[:, t, t1]
        c, e = P[:, t1, t], P[:, t1, t1]
        detc, bad2 = sn_pair_det(a, b, c, e)
        below2 = rows > t1
        u = torch.where(below2, P[:, :, t], 0.0)
        v = torch.where(below2, P[:, :, t1], 0.0)
        lu = (u * e[:, None] - v * c[:, None]) / detc[:, None]
        lv = (v * a[:, None] - u * b[:, None]) / detc[:, None]
        urow1 = torch.where(cols > t1, P[:, t, :], 0.0)
        urow2 = torch.where(cols > t1, P[:, t1, :], 0.0)
        P2 = (P - lu[:, :, None] * urow1[:, None, :]
              - lv[:, :, None] * urow2[:, None, :])
        P2[:, :, t] = torch.where(below2, lu, P[:, :, t])
        P2[:, :, t1] = torch.where(below2, lv, P[:, :, t1])
        Q2 = (Q - lu[:, :wb, None] * Q[:, t, :][:, None, :]
              - lv[:, :wb, None] * Q[:, t1, :][:, None, :])
        s3, sec3 = start[:, None, None], second[:, None, None]
        P = torch.where(s3, P2, torch.where(sec3, P, P1))
        Q = torch.where(s3, Q2, torch.where(sec3, Q, Q1))
        nbad = nbad + torch.where(
            start, bad2.to(dt), torch.where(second, 0.0, bad1.to(dt)))
    return P, Q, nbad.sum()


def sn_schur_ref(P, Q):
    """Batched Schur-complement GEMM: S[l] = Lpanel[l] @ Upanel[l].

    ``P`` (k, wb+rb, wb) factored panels, ``Q`` (k, wb, rb) raw U rows;
    returns (k, rb, rb), scatter-subtracted into the trailing slots."""
    wb = Q.shape[1]
    return torch.einsum("kiw,kwr->kir", P[:, wb:, :], Q)


def sn_gather(C, idx):
    """``C[idx]`` through ``index_select``, which takes int32 slot tables as
    they are."""
    return C.index_select(0, idx.reshape(-1)).view(idx.shape)


def sn_panel_factor_inplace_ref(C, pidx, qidx, wvec, rvec, tau, bkm, *,
                                pairs=False, guard=True):
    """:func:`sn_panel_factor_ref` on the factor vector ``C`` in place:
    gather the panels through the slot tables ``pidx`` (k, wb+rb, wb) and
    ``qidx`` (k, wb, rb), factor them, write the live entries back; pad
    slots keep their values.  Returns nbad."""
    Pg, Qg = sn_gather(C, pidx), sn_gather(C, qidx)
    P, Q, nbad = sn_panel_factor_ref(Pg, Qg, wvec, rvec, tau, bkm,
                                     pairs=pairs, guard=guard)
    pmask, qmask = sn_live_masks(wvec, rvec, P.shape[2], Q.shape[2],
                                 C.device)
    C[pidx] = torch.where(pmask, P, Pg)
    C[qidx] = torch.where(qmask, Q, Qg)
    return nbad


def sn_target_mask(rvec, rb, device):
    """(k, rb, rb) bool: the live entries of a bucket's Schur block S,
    i, j < r_l.  The live-only target table lists them in this mask's
    row-major order: lane by lane, each lane's r × r block row by row."""
    r = rvec.to(device).long()[:, None, None]
    ar = torch.arange(rb, device=device)
    return (ar[None, :, None] < r) & (ar[None, None, :] < r)


def sn_schur_inplace_ref(C, pidx, qidx, wvec, rvec, tgt):
    """The Schur update fused with the extend-add, in place: S = L_sub · U
    (:func:`sn_schur_ref`) on the masked factored panels gathered from
    ``C``, then ``C[tgt] -= S`` over the live entries (:func:`sn_target_mask`,
    in the live-only target table's order; the pads are dropped)."""
    P, Q = sn_panel_mask(sn_gather(C, pidx), sn_gather(C, qidx), wvec, rvec)
    S = sn_schur_ref(P, Q).reshape(-1)
    live = sn_target_mask(rvec, qidx.shape[2], C.device).reshape(-1)
    # each live entry's place in the table, the pads parked one past its end
    # (a scatter, not S[live]: no host sync)
    n = tgt.numel()
    dest = torch.where(live, torch.cumsum(live, 0) - 1, n)
    C.index_add_(0, tgt, S.new_zeros(n + 1).index_copy_(0, dest, S)[:n],
                 alpha=-1)


def sn_trsv_ref(D, y, wvec, bkm, *, mode, pairs=False):
    """Dense triangular solves on a bucket of supernode diagonal blocks.

    ``D`` (k, wb, wb) packed blocks (strict lower = unit-L, diagonal =
    pivots, strict upper = U); ``y`` (k, wb) or (k, wb, m) right-hand sides.
    Modes: ``"l"`` unit-lower forward (L y = b), ``"lt"`` unit-upper
    backward (Lᵀ x = y), ``"u"`` upper backward with pivot divides
    (U x = y), ``"ut"`` lower forward with pivot divides (Uᵀ y = b).  With
    ``pairs`` the pair-start subdiagonal holds raw c (identity in the unit
    factor) and the pivot modes solve each 2x2 system E / Eᵀ jointly."""
    vec = y.dim() == 2
    if vec:
        y = y[:, :, None]
    wb = D.shape[1]
    dev = D.device
    D = sn_block_mask(D, wvec)
    idx = torch.arange(wb, device=dev)[None, :]
    x = torch.where(idx[:, :, None] < wvec.to(dev).long()[:, None, None],
                    y, 0.0)
    bkm = bkm.to(dev).bool()
    one = torch.ones((), dtype=D.dtype, device=dev)
    if pairs and mode in ("l", "lt"):
        sub = (idx[0][:, None] == idx[0][None, :] + 1)[None] & bkm[:, None, :]
        D = torch.where(sub, 0.0, D)
    if mode == "l":
        for t in range(wb):
            col = torch.where(idx > t, D[:, :, t], 0.0)
            x = x - col[:, :, None] * x[:, t:t + 1, :]
    elif mode == "lt":
        for i in range(wb):
            t = wb - 1 - i
            row = torch.where(idx < t, D[:, t, :], 0.0)
            x = x - row[:, :, None] * x[:, t:t + 1, :]
    elif mode in ("u", "ut"):
        for i in range(wb):
            t = (wb - 1 - i) if mode == "u" else i
            if pairs:
                start = bkm[:, t]
                second = bkm[:, max(t - 1, 0)] & (t > 0)
                dd = torch.where(start | second, one, D[:, t, t])
            else:
                dd = D[:, t, t]
            xt1 = x[:, t, :] / dd[:, None]
            if mode == "u":
                prop = torch.where(idx < t, D[:, :, t], 0.0)
            else:
                prop = torch.where(idx > t, D[:, t, :], 0.0)
            x1 = x - prop[:, :, None] * xt1[:, None, :]
            x1[:, t, :] = xt1
            if not pairs:
                x = x1
                continue
            t1 = min(t + 1, wb - 1)
            a, b = D[:, t, t, None], D[:, t, t1, None]
            c, e = D[:, t1, t, None], D[:, t1, t1, None]
            detc, _ = sn_pair_det(a, b, c, e)
            rt, rt1 = x[:, t, :], x[:, t1, :]
            if mode == "u":           # E [xt, xtt] = [rt, rt1]
                xt = (e * rt - b * rt1) / detc
                xtt = (a * rt1 - c * rt) / detc
                p1 = torch.where(idx < t, D[:, :, t], 0.0)
                p2 = torch.where(idx < t, D[:, :, t1], 0.0)
            else:                     # Eᵀ [xt, xtt] = [rt, rt1]
                xt = (e * rt - c * rt1) / detc
                xtt = (a * rt1 - b * rt) / detc
                p1 = torch.where(idx > t1, D[:, t, :], 0.0)
                p2 = torch.where(idx > t1, D[:, t1, :], 0.0)
            x2 = (x - p1[:, :, None] * xt[:, None, :]
                  - p2[:, :, None] * xtt[:, None, :])
            x2[:, t, :] = xt
            x2[:, t1, :] = xtt
            x = torch.where(start[:, None, None], x2,
                            torch.where(second[:, None, None], x, x1))
    else:
        raise ValueError(f"unknown block_trsv mode {mode!r}")
    return x[:, :, 0] if vec else x


def sn_sweep_inplace_ref(C, y, pidx, qidx, rows, wvec, rvec, bkm, *, mode,
                         pairs=False):
    """One bucket of a supernodal triangular sweep on ``y`` (n+1, m), in
    place: the reference's per-bucket sweep step (``_sn_sweep_fn``).

    The factors are gathered from ``C`` through ``pidx`` (k, wb+rb, wb; its
    first wb rows the diagonal block D, the rest L_sub) and ``qidx``
    (k, wb, rb; U), masked to the true sizes; ``rows`` (k, wb+rb) are the
    lanes' rows of ``y``, the block's y_b then the sub-rows' y_s.  ``"l"``:
    x = L_D⁻¹ y_b, y_s −= L_sub x; ``"ut"``: x = U_D⁻ᵀ y_b, y_s −= Uᵀ x;
    ``"u"``: x = U_D⁻¹ (y_b − U y_s); ``"lt"``: x = L_D⁻ᵀ (y_b − L_subᵀ y_s);
    then y_b = x (:func:`sn_trsv_ref` for the block solves).  Pad rows keep
    their values (the scatter adds an exact zero to them).  Returns y."""
    k, mw, wb = pidx.shape
    pmask, qmask = sn_live_masks(wvec, rvec, wb, mw - wb, C.device)
    rows = rows.long()
    rows_b, rows_s = rows[:, :wb], rows[:, wb:]
    D = sn_gather(C, pidx[:, :wb, :])
    if mode in ("l", "lt"):
        F = torch.where(pmask[:, wb:, :], sn_gather(C, pidx[:, wb:, :]), 0.0)
        eq = "kaw,kwm->kam" if mode == "l" else "kaw,kam->kwm"
    else:
        F = torch.where(qmask, sn_gather(C, qidx), 0.0)
        eq = "ktr,ktm->krm" if mode == "ut" else "ktr,krm->ktm"
    yb = y[rows_b]
    tw = (torch.arange(wb, device=C.device)[None, :]
          < wvec.to(C.device).long()[:, None])[:, :, None]
    if mode in ("l", "ut"):
        x = sn_trsv_ref(D, yb, wvec, bkm, mode=mode, pairs=pairs)
        y[rows_b] = torch.where(tw, x, yb)
        upd = torch.einsum(eq, F, x)
        y.index_add_(0, rows_s.reshape(-1), upd.reshape(-1, y.shape[1]),
                     alpha=-1)
    else:
        x = sn_trsv_ref(D, yb - torch.einsum(eq, F, y[rows_s]), wvec, bkm,
                        mode=mode, pairs=pairs)
        y[rows_b] = torch.where(tw, x, yb)
    return y


ATTN_NEG_INF = -1e30            # the reference's attention mask value


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        round_p: bool = False) -> torch.Tensor:
    """Attention softmax(q·kᵀ/√d)·v in f32 (f64 for f64 inputs), the
    result in q's dtype.

    ``q``: (BH, S, d); ``k``, ``v``: (BH, T, d).  ``causal`` keeps key
    j ≤ query i in absolute indices (top-left aligned when T ≠ S).  The
    reference's ``flash_attention_ref``; ``round_p`` rounds the
    probabilities to bf16 once before p·v, as the reference model's jnp
    attention does."""
    d = q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bsd,btd->bst", q.to(acc), k.to(acc)) / (d ** 0.5)
    if causal:
        S, T = s.shape[-2:]
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        s = torch.where((j <= i)[None], s, ATTN_NEG_INF)
    p = torch.softmax(s, dim=-1)
    if round_p:
        p = p.to(torch.bfloat16).to(acc)
    return torch.einsum("bst,btd->bsd", p, v.to(acc)).to(q.dtype)
