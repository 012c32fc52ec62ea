"""Supernodal panel kernels — wrappers of ``csrc/supernode.cu``.

Replaces the TPU kernels of ``repro/kernels/supernode.py``:

- :func:`panel_factor_inplace` — right-looking dense factorization of a
  bucket of (wb+rb, wb) supernode panels and their (wb, rb) U panels, read
  and written in place in the factor vector ``C`` through the bucket's slot
  tables, with the 1x1 pivot clamp and the static Bunch–Kaufman 2x2 pairs;
- :func:`schur_update_inplace` — the batched Schur GEMM S = L_sub · U fused
  with the extend-add: it subtracts S from the ancestors' slots of ``C``
  through the live-only target table, without forming S;
- :func:`block_trsv` — triangular solves on the diagonal blocks, modes
  ``l``/``lt``/``u``/``ut``, for m ≥ 1 right-hand sides.

On CUDA tensors each function launches its hand-written kernel (or
raises); on CPU tensors it runs the plain version in ``ref.py``.  Every
kernel masks pad rows, columns and lanes itself (pad slots hold garbage);
the in-place kernels never write a pad slot.  Bounds: bytes for all three
(see the source's header).
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


def _slot_tables(what, C, pidx, qidx):
    """(k, wb, rb) of a bucket's int32 slot tables on ``C``'s device."""
    if C.dim() != 1 or not C.is_contiguous():
        raise ValueError(f"{what}: C must be a contiguous vector")
    if pidx.dim() != 3 or qidx.dim() != 3:
        raise ValueError(f"{what}: pidx / qidx must be 3-D")
    k, m, wb = pidx.shape
    rb = m - wb
    if tuple(qidx.shape) != (k, wb, rb) or not 1 <= wb <= 32:
        raise ValueError(f"{what}: pidx {tuple(pidx.shape)} / qidx "
                         f"{tuple(qidx.shape)} are not (k, wb+rb, wb) / "
                         f"(k, wb, rb) with wb <= 32")
    for name, t in (("pidx", pidx), ("qidx", qidx)):
        if t.dtype != torch.int32 or t.device != C.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"tensor on {C.device}")
    return k, wb, rb


def panel_factor_inplace(C, pidx, qidx, wvec, rvec, tau, bkm, *, pairs=False,
                         guard=True, nbad=None, work=None):
    """Factorize a bucket of supernode panels in place in ``C``.

    ``C`` the factor vector; ``pidx`` (k, wb+rb, wb) / ``qidx`` (k, wb, rb)
    int32 slots of the [D-block; L-panel] columns and the U-panel rows (pad
    entries may all name one scratch slot: it is read, masked, and never
    written); ``wvec``/``rvec`` (k,) true width/sub-row counts, ``tau`` the
    1x1 pivot clamp (number or 0-dim tensor), ``bkm`` (k, wb) bool
    pair-start flags.  Leaves L divided, U raw and clamped pivots persisted
    in ``C``.  ``nbad`` (0-dim, ``C``'s dtype and device) is added into in
    place and returned: the count of clamped 1x1 pivots and 2x2
    determinants.  ``work``: on CUDA, an int32 vector of at least k zeros
    that the kernel leaves zeroed (one per factorization serves every
    bucket); allocated here when None."""
    if nbad is None:
        nbad = torch.zeros((), dtype=C.dtype, device=C.device)
    if C.device.type == "cpu":
        return nbad.add_(_ref.sn_panel_factor_inplace_ref(
            C, pidx, qidx, wvec, rvec, tau, bkm, pairs=pairs, guard=guard))
    what = "panel_factor"
    f64 = _cuda_args(what, (C,), C.dtype)
    k, wb, rb = _slot_tables(what, C, pidx, qidx)
    wv = _lane_vec(wvec, k, what, "wvec")
    rv = _lane_vec(rvec, k, what, "rvec")
    bk = _lane_flags(bkm, k, wb, what)
    tau_t = torch.as_tensor(tau, dtype=C.dtype, device=C.device).reshape(())
    if nbad.dim() != 0 or nbad.dtype != C.dtype or nbad.device != C.device:
        raise ValueError(f"{what}: nbad must be a 0-dim {C.dtype} tensor on "
                         f"{C.device}")
    if work is None:
        work = torch.zeros(k, dtype=torch.int32, device=C.device)
    if work.dtype != torch.int32 or work.device != C.device \
            or work.numel() < k:
        raise ValueError(f"{what}: work must be an int32 tensor of at least "
                         f"{k} zeros on {C.device}")
    _build.check(_build.lib().sn_panel_factor(
        int(f64), C.data_ptr(), pidx.data_ptr(), qidx.data_ptr(),
        wv.data_ptr(), rv.data_ptr(), tau_t.data_ptr(), bk.data_ptr(),
        nbad.data_ptr(), work.data_ptr(), k, wb, rb, int(bool(pairs)),
        int(bool(guard)), _build.stream_ptr(C)), what)
    LAUNCHES["panel_factor"] += 1
    return nbad


panel_factor_inplace.passes = (2, 2)


def schur_update_inplace(C, pidx, qidx, wvec, rvec, tgt, toff):
    """Schur update fused with the extend-add, in place in ``C``.

    For every lane l with w_l > 0 and every i, j < r_l:
    ``C[tgt[toff[l] + i*r_l + j]] -= sum_c L_sub[l, i, c] * U[l, c, j]``,
    the factored panels read from ``C`` through ``pidx``/``qidx`` (pads
    masked).  ``tgt`` the live-only int32 target table (per lane its
    r_l x r_l block, lane by lane), ``toff`` (k+1,) int64 its lane offsets.
    No S is formed and no pad slot is touched.  Returns ``C``."""
    if C.device.type == "cpu":
        _ref.sn_schur_inplace_ref(C, pidx, qidx, wvec, rvec, tgt)
        return C
    what = "schur_update"
    f64 = _cuda_args(what, (C,), C.dtype)
    k, wb, rb = _slot_tables(what, C, pidx, qidx)
    wv = _lane_vec(wvec, k, what, "wvec")
    rv = _lane_vec(rvec, k, what, "rvec")
    if tgt.dtype != torch.int32 or tgt.dim() != 1 or toff.dtype != torch.int64 \
            or tuple(toff.shape) != (k + 1,) or tgt.device != C.device \
            or toff.device != C.device:
        raise ValueError(f"{what}: tgt must be an int32 vector and toff a "
                         f"({k + 1},) int64 vector on {C.device}")
    _build.check(_build.lib().sn_schur_update(
        int(f64), C.data_ptr(), pidx.data_ptr(), qidx.data_ptr(),
        wv.data_ptr(), rv.data_ptr(), tgt.contiguous().data_ptr(),
        toff.contiguous().data_ptr(), k, wb, rb, _build.stream_ptr(C)), what)
    LAUNCHES["schur_update"] += 1
    return C


schur_update_inplace.passes = (3, 1)


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
