"""Supernodal panel kernels — wrappers of ``csrc/supernode.cu``.

Replaces the TPU kernels of ``repro/kernels/supernode.py``:

- :func:`panel_factor` — right-looking dense factorization of a bucket of
  (wb+rb, wb) supernode panels and their (wb, rb) U panels, with the 1x1
  pivot clamp and the static Bunch–Kaufman 2x2 pairs;
- :func:`schur_update` — the batched Schur GEMM S = L_sub · U that the
  direct solver scatter-subtracts into the ancestors' slots (extend-add);
- :func:`block_trsv` — triangular solves on the diagonal blocks, modes
  ``l``/``lt``/``u``/``ut``, for m ≥ 1 right-hand sides.

On CUDA tensors each function launches its hand-written kernel (or
raises); on CPU tensors it runs the plain version in ``ref.py``.  Every
kernel masks pad rows, columns and lanes itself (gathered pad slots hold
garbage).  Bounds: bytes for all three (see the source's header).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

#: launches of each CUDA kernel (plain integers; reset by the caller)
LAUNCHES = {"panel_factor": 0, "schur_update": 0, "block_trsv": 0}
TRSV_MODES = {"l": 0, "lt": 1, "u": 2, "ut": 3}
#: block_trsv launches by mode (the adjoint's transposed sweeps run ut / lt)
TRSV_MODE_LAUNCHES = dict.fromkeys(TRSV_MODES, 0)


def _cuda_args(what, tensors, dtype):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors must share one CUDA device")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]} differ")
    return _build.cuda_dtype_tag(dtype) == "f64"


def _lane_vec(v, k, what, name):
    if v.dim() != 1 or v.shape[0] != k:
        raise ValueError(f"{what}: {name} must have shape ({k},), got "
                         f"{tuple(v.shape)}")
    return v.to(torch.int32).contiguous()


def _lane_flags(bkm, k, wb, what):
    if tuple(bkm.shape) != (k, wb):
        raise ValueError(f"{what}: bkm must have shape ({k}, {wb}), got "
                         f"{tuple(bkm.shape)}")
    return bkm.to(torch.bool).contiguous()


def panel_factor(P, Q, wvec, rvec, tau, bkm, *, pairs=False, guard=True,
                 nbad=None):
    """Factorize a bucket of supernode panels.

    ``P`` (k, wb+rb, wb) gathered [D-block; L-panel] columns, ``Q``
    (k, wb, rb) gathered U-panel rows, ``wvec``/``rvec`` (k,) true
    width/sub-row counts, ``tau`` the 1x1 pivot clamp (number or 0-dim
    tensor), ``bkm`` (k, wb) bool pair-start flags.  Returns new
    (P, Q, nbad): L divided, U raw, clamped pivots persisted, ``nbad`` a
    0-dim tensor counting clamped 1x1 pivots and 2x2 determinants.  A
    caller's 0-dim ``nbad`` accumulator (panel dtype and device) is added
    into in place and returned, so one factorization keeps one count."""
    if nbad is None:
        nbad = torch.zeros((), dtype=P.dtype, device=P.device)
    if P.device.type == "cpu":
        P, Q, nb = _ref.sn_panel_factor_ref(P, Q, wvec, rvec, tau, bkm,
                                            pairs=pairs, guard=guard)
        return P, Q, nbad.add_(nb)
    what = "panel_factor"
    f64 = _cuda_args(what, (P, Q), P.dtype)
    k, m, wb = P.shape
    rb = m - wb
    if tuple(Q.shape) != (k, wb, rb) or not 1 <= wb <= 32:
        raise ValueError(f"{what}: P {tuple(P.shape)} / Q {tuple(Q.shape)} "
                         f"are not (k, wb+rb, wb) / (k, wb, rb) with wb <= 32")
    P = P.contiguous()
    Q = Q.contiguous()
    wv = _lane_vec(wvec, k, what, "wvec")
    rv = _lane_vec(rvec, k, what, "rvec")
    bk = _lane_flags(bkm, k, wb, what)
    tau_t = torch.as_tensor(tau, dtype=P.dtype, device=P.device).reshape(())
    if nbad.dim() != 0 or nbad.dtype != P.dtype or nbad.device != P.device:
        raise ValueError(f"{what}: nbad must be a 0-dim {P.dtype} tensor on "
                         f"{P.device}")
    Po = torch.empty_like(P)
    Qo = torch.empty_like(Q)
    _build.check(_build.lib().sn_panel_factor(
        int(f64), P.data_ptr(), Q.data_ptr(), Po.data_ptr(), Qo.data_ptr(),
        wv.data_ptr(), rv.data_ptr(), tau_t.data_ptr(), bk.data_ptr(),
        nbad.data_ptr(), k, wb, rb, int(bool(pairs)), int(bool(guard)),
        _build.stream_ptr(P)), what)
    LAUNCHES["panel_factor"] += 1
    return Po, Qo, nbad


panel_factor.passes = (2, 2)


def schur_update(P, Q):
    """Extend-add GEMM: S[l] = Lpanel[l] @ Upanel[l] per lane.

    ``P`` (k, wb+rb, wb) factored panels (rows wb.. hold the divided L),
    ``Q`` (k, wb, rb) raw U rows.  Returns S (k, rb, rb)."""
    if P.device.type == "cpu":
        return _ref.sn_schur_ref(P, Q)
    what = "schur_update"
    f64 = _cuda_args(what, (P, Q), P.dtype)
    k, m, wb = P.shape
    rb = m - wb
    if tuple(Q.shape) != (k, wb, rb) or not 1 <= wb <= 32:
        raise ValueError(f"{what}: P {tuple(P.shape)} / Q {tuple(Q.shape)} "
                         f"are not (k, wb+rb, wb) / (k, wb, rb) with wb <= 32")
    P = P.contiguous()
    Q = Q.contiguous()
    S = torch.empty(k, rb, rb, dtype=P.dtype, device=P.device)
    _build.check(_build.lib().sn_schur_update(
        int(f64), P.data_ptr(), Q.data_ptr(), S.data_ptr(), k, wb, rb,
        _build.stream_ptr(P)), what)
    LAUNCHES["schur_update"] += 1
    return S


schur_update.passes = (2, 1)


def block_trsv(D, y, wvec, bkm, *, mode, pairs=False):
    """Dense triangular solves on a bucket of diagonal blocks.

    ``D`` (k, wb, wb) packed blocks (strict lower = unit-L, diagonal =
    pivots, strict upper = U; a lane stride other than wb² is taken as it
    is, so a view of the gathered (k, wb+rb, wb) panel needs no copy),
    ``y`` (k, wb) or (k, wb, m) right-hand sides, ``mode`` one of
    ``"l"``/``"lt"``/``"u"``/``"ut"`` (see ``ref.sn_trsv_ref``).  Returns x
    shaped like ``y``."""
    if mode not in TRSV_MODES:
        raise ValueError(f"unknown block_trsv mode {mode!r}")
    if D.device.type == "cpu":
        return _ref.sn_trsv_ref(D, y, wvec, bkm, mode=mode, pairs=pairs)
    what = "block_trsv"
    f64 = _cuda_args(what, (D, y), D.dtype)
    k, wb = D.shape[0], D.shape[1]
    vec = y.dim() == 2
    yy = y[:, :, None] if vec else y
    if tuple(D.shape) != (k, wb, wb) or yy.dim() != 3 \
            or tuple(yy.shape[:2]) != (k, wb) or not 1 <= wb <= 32:
        raise ValueError(f"{what}: D {tuple(D.shape)} / y {tuple(y.shape)} "
                         f"are not (k, wb, wb) / (k, wb[, m]) with wb <= 32")
    if D.stride(2) != 1 or D.stride(1) != wb:
        D = D.contiguous()
    yy = yy.contiguous()
    m = yy.shape[2]
    wv = _lane_vec(wvec, k, what, "wvec")
    bk = _lane_flags(bkm, k, wb, what)
    x = torch.empty_like(yy)
    _build.check(_build.lib().sn_block_trsv(
        int(f64), TRSV_MODES[mode], int(bool(pairs)), D.data_ptr(),
        D.stride(0), yy.data_ptr(), x.data_ptr(), wv.data_ptr(),
        bk.data_ptr(), k, wb, m, _build.stream_ptr(D)), what)
    LAUNCHES["block_trsv"] += 1
    TRSV_MODE_LAUNCHES[mode] += 1
    return x[:, :, 0] if vec else x


block_trsv.passes = (2, 1)
