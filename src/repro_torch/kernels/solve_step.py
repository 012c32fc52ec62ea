"""Fused CG/BiCGStab step passes — wrappers of ``csrc/solve_step.cu``.

Replaces the TPU kernel family ``repro/kernels/solve_step.py`` (one
``pallas_call`` template, eight bodies).  Each function below streams its
n-vectors once, producing its vector outputs and its reduction dots in the
same pass.  On CUDA tensors the hand-written kernel runs (or the call
raises); on CPU tensors the plain version in ``ref.py`` runs.

Two arguments the reference does not have serve the solver loops:

* ``out`` — tensors to write the vector outputs into (they may alias the
  inputs element for element, e.g. ``x`` updated in place);
* ``active`` — a 0-dim int32 device flag; when it is 0 the vector writes are
  skipped (the dots are still returned).  A Krylov loop carries this flag
  so that it can check convergence on the host only every few iterations.

Scalars may be Python numbers or 0-dim tensors on the vectors' device; the
dots come back as 0-dim tensors on that device, so the loop never waits on
the host for a coefficient.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref as _ref

THREADS = 256            # threads per block of the streaming kernel
MAX_BLOCKS = 132 * 8     # grid cap: 8 resident blocks on each of 132 SMs

# name → (body id in csrc/solve_step.cu, n_in, n_sc, n_out, n_dot)
BODIES = {
    "fused_cg_update": (0, 5, 1, 3, 2),
    "fused_cg_direction": (1, 4, 1, 2, 1),
    "fused_cg_halfstep": (2, 4, 1, 2, 1),
    "fused_cheb_step": (3, 3, 2, 2, 0),
    "fused_dots2": (4, 2, 0, 0, 2),
    "fused_bicg_p": (5, 4, 3, 2, 0),
    "fused_bicg_s": (6, 3, 1, 2, 0),
    "fused_bicg_tail": (7, 6, 2, 2, 2),
}

#: launches of each body's CUDA kernel (plain integers; reset by the caller)
LAUNCHES = dict.fromkeys(BODIES, 0)


def default_interpret(device=None) -> bool:
    """True where the plain versions run (CPU tensors), False on CUDA — the
    port's reading of the reference's interpret-mode platform test."""
    return torch.device("cpu" if device is None else device).type != "cuda"


def n_blocks(n: int) -> int:
    """Grid size of the streaming kernel for n elements (depends on n only,
    so the two-pass reduction order is the same on every run)."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def _scalar(s, like: torch.Tensor) -> torch.Tensor:
    if isinstance(s, torch.Tensor):
        if s.numel() != 1:
            raise ValueError(f"scalar argument has shape {tuple(s.shape)}")
        return s.reshape(()).to(device=like.device, dtype=like.dtype)
    return torch.full((), float(s), dtype=like.dtype, device=like.device)


def _run_cpu(name, vecs, scalars, out, active, n_out):
    res = getattr(_ref, name + "_ref")(*vecs, *scalars)
    if out is None:
        return res
    if active is None or bool(active):
        for o, v in zip(out, res[:n_out]):
            o.copy_(v)
    return tuple(out) + tuple(res[n_out:])


def _run(name, vecs, scalars, out=None, active=None):
    bid, n_in, n_sc, n_out, n_dot = BODIES[name]
    v0 = vecs[0]
    if v0.device.type == "cpu":
        return _run_cpu(name, vecs, scalars, out, active, n_out)
    dev, dtype, n = v0.device, v0.dtype, v0.numel()
    tag = _build.cuda_dtype_tag(dtype)
    for v in vecs:
        if v.device != dev or v.dtype != dtype or v.dim() != 1 \
                or v.numel() != n or not v.is_contiguous():
            raise ValueError(
                f"{name}: every vector must be a contiguous 1-D {dtype} "
                f"tensor of length {n} on {dev}")
    sc = [_scalar(s, v0) for s in scalars]
    if out is None:
        out = [torch.empty_like(v0) for _ in range(n_out)]
    elif len(out) != n_out or any(
            o.device != dev or o.dtype != dtype or o.numel() != n
            or not o.is_contiguous() for o in out):
        raise ValueError(f"{name}: out must be {n_out} contiguous vectors "
                         f"like the inputs")
    if active is not None and (active.device != dev or active.numel() != 1
                               or active.dtype != torch.int32):
        raise ValueError(f"{name}: active must be a 0-dim int32 tensor on {dev}")
    nb = n_blocks(n)
    partials = torch.empty(nb * n_dot, dtype=dtype, device=dev) if n_dot else None
    dots = torch.empty(n_dot, dtype=dtype, device=dev) if n_dot else None
    ptrs_in = (ctypes.c_void_p * 6)(*[v.data_ptr() for v in vecs])
    ptrs_out = (ctypes.c_void_p * 3)(*[o.data_ptr() for o in out])
    ptrs_sc = (ctypes.c_void_p * 3)(*[s.data_ptr() for s in sc])
    rc = _build.lib().fused_step(
        bid, 0 if tag == "f32" else 1, ptrs_in, ptrs_out, ptrs_sc,
        None if active is None else active.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if dots is None else dots.data_ptr(),
        n, nb, _build.stream_ptr(v0))
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return tuple(out) + tuple(dots[j] for j in range(n_dot))


# ---------------------------------------------------------------------------
# CG (merged recurrence, diagonal preconditioner)
# ---------------------------------------------------------------------------

def fused_cg_update(x, r, p, s, dinv, alpha, *, out=None, active=None):
    """x' = x + α·p;  r' = r − α·s;  z' = dinv·r';  ρ' = <r',z'>;  rr' = <r',r'>."""
    return _run("fused_cg_update", (x, r, p, s, dinv), (alpha,), out, active)


fused_cg_update.passes = (5, 3)


def fused_cg_direction(z, w, p, s, beta, *, out=None, active=None):
    """p' = z + β·p;  s' = w + β·s;  δ = <w,z>  (w = A z)."""
    return _run("fused_cg_direction", (z, w, p, s), (beta,), out, active)


fused_cg_direction.passes = (4, 2)


def fused_cg_halfstep(x, r, p, s, alpha, *, out=None, active=None):
    """x' = x + α·p;  r' = r − α·s;  rr' = <r',r'> — the partial fusion used
    when the preconditioner apply is not a diagonal scale."""
    return _run("fused_cg_halfstep", (x, r, p, s), (alpha,), out, active)


fused_cg_halfstep.passes = (4, 2)


def fused_cheb_step(x, dk, rk, c1, c2, *, out=None, active=None):
    """d' = c1·d + c2·r;  x' = x + d' — one inner Chebyshev step."""
    return _run("fused_cheb_step", (x, dk, rk), (c1, c2), out, active)


fused_cheb_step.passes = (3, 2)


def fused_dots2(u, v):
    """(Σ u·v, Σ u·u) in one read of each operand."""
    return _run("fused_dots2", (u, v), ())


fused_dots2.passes = (2, 0)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def fused_bicg_p(r, p, v, dinv, beta, omega, restart, *, out=None,
                 active=None):
    """p' = r + β·(p − ω·v)  (p' = r when the restart flag is set);
    p̂ = dinv·p'."""
    return _run("fused_bicg_p", (r, p, v, dinv), (beta, omega, restart),
                out, active)


fused_bicg_p.passes = (4, 2)


def fused_bicg_s(r, v, dinv, alpha, *, out=None, active=None):
    """s = r − α·v;  ŝ = dinv·s."""
    return _run("fused_bicg_s", (r, v, dinv), (alpha,), out, active)


fused_bicg_s.passes = (3, 2)


def fused_bicg_tail(x, s, t, phat, shat, rhat, alpha, omega, *, out=None,
                    active=None):
    """x' = x + α·p̂ + ω·ŝ;  r' = s − ω·t;  ρ' = <r̂,r'>;  rr' = <r',r'>."""
    return _run("fused_bicg_tail", (x, s, t, phat, shat, rhat),
                (alpha, omega), out, active)


fused_bicg_tail.passes = (6, 2)
