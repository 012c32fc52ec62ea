"""Plain PyTorch versions of the hand-written CUDA kernels.

Each kernel wrapper in this package runs its plain version here when the
tensors it is given lie on the CPU; ``chip_smoke.py`` holds every kernel
against its plain version on the card.  The formulas are those of the
reference's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
