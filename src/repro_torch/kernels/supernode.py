"""Supernodal panel kernels — wrappers of ``csrc/supernode.cu``.

Replaces the TPU kernels of ``repro/kernels/supernode.py``:

- :func:`panel_factor_inplace` — right-looking dense factorization of a
  bucket of (wb+rb, wb) supernode panels and their (wb, rb) U panels, read
  and written in place in the factor vector ``C`` through the bucket's slot
  tables, with the 1x1 pivot clamp and the static Bunch–Kaufman 2x2 pairs;
- :func:`schur_update_inplace` — the batched Schur GEMM S = L_sub · U fused
  with the extend-add: it subtracts S from the ancestors' slots of ``C``
  through the live-only target table, without forming S;
- :func:`sn_sweep_inplace` — one bucket of a triangular sweep in place in
  the solution ``y``: the diagonal-block solve (``block_trsv``, modes
  ``l``/``lt``/``u``/``ut``) fused with its panel GEMV and the scatter into
  (or gather from) the ancestors' rows, the factors read from ``C``;
- :func:`block_trsv` — the diagonal-block solves alone, on (k, wb, wb)
  blocks, for m ≥ 1 right-hand sides (the same kernel, with no sub-rows).

**Lanes** (the reference's ``jax.vmap`` of these kernels over B value
arrays of one pattern): ``C`` may be a ``(B, nnzF+2)`` stack of factor
vectors, one per lane, with ``tau`` and ``nbad`` then ``(B,)`` (a 0-dim
``tau`` serves every lane) and the sweep's ``y`` a ``(B, n+1, m)`` stack.
The slot tables are shared; ONE launch per call serves every lane (the lane
is on the kernel's grid z), so a factorization or a sweep costs the
launches of one lane whatever B is.  Lane-stacked launches count under
``<name>_lanes``.

On CUDA tensors each function launches its hand-written kernel (or
raises); on CPU tensors it runs the plain version in ``ref.py``.  Every
kernel masks pad rows, columns and lanes itself (pad slots hold garbage);
the in-place kernels never write a pad slot.  Bounds: bytes for all of
them (see the source's header).
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

#: launches of each CUDA kernel (plain integers; reset by the caller)
LAUNCHES = dict.fromkeys(("panel_factor", "schur_update", "sn_sweep",
                          "panel_factor_lanes", "schur_update_lanes",
                          "sn_sweep_lanes"), 0)
SWEEP_MODES = {"l": 0, "lt": 1, "u": 2, "ut": 3}
#: sn_sweep launches by mode (the adjoint's transposed sweeps run ut / lt)
SWEEP_MODE_LAUNCHES = dict.fromkeys(SWEEP_MODES, 0)
#: items (sub-rows or U columns) and right-hand sides of one sn_sweep block,
#: and the partial sums a block leaves (kSwMaxThreads, kSwRhs in the source)
SWEEP_ITEMS, SWEEP_RHS = 128, 4
SWEEP_PART = SWEEP_RHS * 32


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


def _value_lanes(what, C):
    """(lanes, lane stride) of a factor vector (nnzF+2,) — one lane, stride
    0 — or of a contiguous lane stack (B, nnzF+2)."""
    if C.dim() not in (1, 2) or not C.is_contiguous():
        raise ValueError(f"{what}: C must be a contiguous vector or a "
                         f"contiguous (B, nnzF+2) lane stack")
    return (1, 0) if C.dim() == 1 else (C.shape[0], C.shape[1])


def _count(name, C):
    LAUNCHES[name + ("_lanes" if C.dim() == 2 else "")] += 1


def _slot_tables(what, C, pidx, qidx):
    """(k, wb, rb) of a bucket's int32 slot tables on ``C``'s device, and
    (lanes, lane stride) of ``C`` (:func:`_value_lanes`)."""
    lanes = _value_lanes(what, C)
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
    return (k, wb, rb) + lanes


def panel_factor_inplace(C, pidx, qidx, wvec, rvec, tau, bkm, *, pairs=False,
                         guard=True, nbad=None, work=None):
    """Factorize a bucket of supernode panels in place in ``C``.

    ``C`` the factor vector, or a (B, nnzF+2) stack of them (see Lanes
    above: ``tau`` then 0-dim or (B,), ``nbad`` (B,), ``work`` B·k zeros);
    ``pidx`` (k, wb+rb, wb) / ``qidx`` (k, wb, rb)
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
        nbad = C.new_zeros(C.shape[:-1])
    if C.device.type == "cpu":
        return nbad.add_(_ref.sn_panel_factor_inplace_ref(
            C, pidx, qidx, wvec, rvec, tau, bkm, pairs=pairs, guard=guard))
    what = "panel_factor"
    f64 = _cuda_args(what, (C,), C.dtype)
    k, wb, rb, nl, ldc = _slot_tables(what, C, pidx, qidx)
    wv = _lane_vec(wvec, k, what, "wvec")
    rv = _lane_vec(rvec, k, what, "rvec")
    bk = _lane_flags(bkm, k, wb, what)
    tau_t = torch.as_tensor(tau, dtype=C.dtype, device=C.device)
    if tau_t.numel() == 1:
        tau_t = tau_t.reshape(1).expand(nl)
    elif tuple(tau_t.shape) != tuple(C.shape[:-1]):
        raise ValueError(f"{what}: tau must be one number or one per lane "
                         f"{tuple(C.shape[:-1])}, got {tuple(tau_t.shape)}")
    tau_t = tau_t.contiguous()
    if tuple(nbad.shape) != tuple(C.shape[:-1]) or nbad.dtype != C.dtype \
            or nbad.device != C.device or not nbad.is_contiguous():
        raise ValueError(f"{what}: nbad must be a contiguous {C.dtype} "
                         f"tensor of shape {tuple(C.shape[:-1])} on "
                         f"{C.device}")
    if work is None:
        work = torch.zeros(nl * k, dtype=torch.int32, device=C.device)
    if work.dtype != torch.int32 or work.device != C.device \
            or work.numel() < nl * k:
        raise ValueError(f"{what}: work must be an int32 tensor of at least "
                         f"{nl * k} zeros on {C.device}")
    _build.check(_build.lib().sn_panel_factor(
        int(f64), C.data_ptr(), ldc, nl, pidx.data_ptr(), qidx.data_ptr(),
        wv.data_ptr(), rv.data_ptr(), tau_t.data_ptr(), bk.data_ptr(),
        nbad.data_ptr(), work.data_ptr(), k, wb, rb, int(bool(pairs)),
        int(bool(guard)), _build.stream_ptr(C)), what)
    _count("panel_factor", C)
    return nbad


panel_factor_inplace.passes = (2, 2)


def schur_update_inplace(C, pidx, qidx, wvec, rvec, tgt, toff):
    """Schur update fused with the extend-add, in place in ``C``.

    For every lane l with w_l > 0 and every i, j < r_l:
    ``C[tgt[toff[l] + i*r_l + j]] -= sum_c L_sub[l, i, c] * U[l, c, j]``,
    the factored panels read from ``C`` through ``pidx``/``qidx`` (pads
    masked).  ``tgt`` the live-only int32 target table (per lane its
    r_l x r_l block, lane by lane), ``toff`` (k+1,) int64 its lane offsets.
    No S is formed and no pad slot is touched.  ``C`` (B, nnzF+2): each
    lane's panels into its own factors, one launch.  Returns ``C``."""
    if C.device.type == "cpu":
        _ref.sn_schur_inplace_ref(C, pidx, qidx, wvec, rvec, tgt)
        return C
    what = "schur_update"
    f64 = _cuda_args(what, (C,), C.dtype)
    k, wb, rb, nl, ldc = _slot_tables(what, C, pidx, qidx)
    wv = _lane_vec(wvec, k, what, "wvec")
    rv = _lane_vec(rvec, k, what, "rvec")
    if tgt.dtype != torch.int32 or tgt.dim() != 1 or toff.dtype != torch.int64 \
            or tuple(toff.shape) != (k + 1,) or tgt.device != C.device \
            or toff.device != C.device:
        raise ValueError(f"{what}: tgt must be an int32 vector and toff a "
                         f"({k + 1},) int64 vector on {C.device}")
    _build.check(_build.lib().sn_schur_update(
        int(f64), C.data_ptr(), ldc, nl, pidx.data_ptr(), qidx.data_ptr(),
        wv.data_ptr(), rv.data_ptr(), tgt.contiguous().data_ptr(),
        toff.contiguous().data_ptr(), k, wb, rb, _build.stream_ptr(C)), what)
    _count("schur_update", C)
    return C


schur_update_inplace.passes = (3, 1)


def sweep_grid(rb, m):
    """(item tiles, right-hand-side groups) of an sn_sweep launch on a
    bucket of rb sub-rows with m right-hand sides: its grid is (k, tiles,
    groups)."""
    return max(1, -(-rb // SWEEP_ITEMS)), -(-m // SWEEP_RHS)


def sweep_buffers(buckets, m, dtype, device, lanes=1):
    """(work, part) for sn_sweep launches on ``buckets`` with m right-hand
    sides and ``lanes`` value lanes: ``work`` int32 zeros, one counter per
    (value lane, lane, group), left zeroed by every launch; ``part`` the
    partial sums of lanes split over several blocks (None where no bucket
    splits).  One pair serves a whole solve."""
    nwork, npart = 1, 0
    for bk in buckets:
        k = bk.wvec.shape[0] * lanes
        tiles, groups = sweep_grid(bk.rb, m)
        nwork = max(nwork, k * groups)
        if tiles > 1:
            npart = max(npart, k * groups * tiles * SWEEP_PART)
    work = torch.zeros(nwork, dtype=torch.int32, device=device)
    part = torch.empty(npart, dtype=dtype, device=device) if npart else None
    return work, part


def check_sweep_bucket(bk, device):
    """Raise unless ``bk``'s tables are what :func:`sn_sweep_inplace` reads
    without checking: int32 ``pidx`` (k, wb+rb, wb), ``qidx`` (k, wb, rb),
    ``rows`` (k, wb+rb), ``wvec``/``rvec`` (k,), a one-byte ``bkm``
    (k, wb), all contiguous on ``device``, wb <= 32."""
    k, wb, rb = bk.wvec.shape[0], bk.wb, bk.rb
    dev = torch.device(device)
    want = {"pidx": ((k, wb + rb, wb), torch.int32),
            "qidx": ((k, wb, rb), torch.int32),
            "rows": ((k, wb + rb), torch.int32),
            "wvec": ((k,), torch.int32), "rvec": ((k,), torch.int32),
            "bkm": ((k, wb), torch.bool)}
    for name, (shape, dtype) in want.items():
        t = getattr(bk, name)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device.type != dev.type or not t.is_contiguous() \
                or dev.index is not None and t.device.index != dev.index:
            raise ValueError(f"sn_sweep: bucket field {name} must be a "
                             f"contiguous {dtype} tensor of shape {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not 1 <= wb <= 32:
        raise ValueError(f"sn_sweep: wb = {wb} is not in [1, 32]")


def _sweep_launch(what, C, y, pidx, qidx, rows, wvec, rvec, bkm, work, part,
                  k, wb, rb, mode, pairs, nl=1, ldc=0, ldy=0):
    """One sn_sweep launch; ``nl`` value lanes, lane b's factors at
    C + b·ldc and its y at y + b·ldy."""
    f64 = _cuda_args(what, (C, y), C.dtype)
    _build.check(_build.lib().sn_sweep(
        int(f64), SWEEP_MODES[mode], int(bool(pairs)), C.data_ptr(), ldc,
        y.data_ptr(), ldy, nl,
        pidx.data_ptr(), qidx.data_ptr(), rows.data_ptr(),
        wvec.data_ptr(), rvec.data_ptr(), bkm.data_ptr(),
        0 if work is None else work.data_ptr(),
        0 if part is None else part.data_ptr(), k, wb, rb, y.shape[-1],
        _build.stream_ptr(y)), what)
    SWEEP_MODE_LAUNCHES[mode] += 1


def sn_sweep_inplace(C, y, bk, mode, *, work=None, part=None):
    """One bucket of a supernodal triangular sweep, in place in ``y``.

    ``y`` (n+1, m) the permuted solution, row n a scratch row; ``C`` the
    factor vector — or, for B value lanes, ``C`` (B, nnzF+2) and ``y``
    (B, n+1, m), lane b's sweep on lane b's factors; ``bk`` the bucket (a ``direct.SnodeBucket`` from
    ``direct.to_device``: ``pidx``, ``qidx``, ``rows`` — each lane's wb
    block rows then its rb sub-rows, pads naming row n — ``wvec``, ``rvec``,
    ``bkm``, ``pairs``).  ``mode``: ``"l"`` x = L_D⁻¹ y_b, y_s −= L_sub x;
    ``"ut"`` x = U_D⁻ᵀ y_b, y_s −= Uᵀ x; ``"u"`` x = U_D⁻¹ (y_b − U y_s);
    ``"lt"`` x = L_D⁻ᵀ (y_b − L_subᵀ y_s); then y_b = x (see
    ``ref.sn_sweep_inplace_ref``).  Pad rows of ``y`` are never written.
    ``work``/``part``: on CUDA, the buffers of :func:`sweep_buffers`
    (allocated here when None).  The bucket's tables are not checked here
    (``direct.to_device`` does, once, through :func:`check_sweep_bucket`).
    Returns ``y``."""
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if C.device.type == "cpu":
        _ref.sn_sweep_inplace_ref(C, y, bk.pidx, bk.qidx, bk.rows, bk.wvec,
                                  bk.rvec, bk.bkm, mode=mode, pairs=bk.pairs)
        return y
    what = "sn_sweep"
    nl, ldc = _value_lanes(what, C)
    if y.dim() != C.dim() + 1 or not y.is_contiguous() \
            or C.dim() == 2 and y.shape[0] != nl:
        raise ValueError(f"{what}: C {tuple(C.shape)} and y "
                         f"{tuple(y.shape)} are not a vector and a contiguous "
                         f"(n+1, m) matrix, or ({nl}, nnzF+2) lanes and a "
                         f"contiguous ({nl}, n+1, m) stack")
    k = bk.wvec.shape[0] * nl
    tiles, groups = sweep_grid(bk.rb, y.shape[-1])
    if work is None:
        work, part = sweep_buffers((bk,), y.shape[-1], C.dtype, C.device, nl)
    if work.numel() < k * groups or tiles > 1 and (
            part is None or part.numel() < k * groups * tiles * SWEEP_PART):
        raise ValueError(f"{what}: work / part are smaller than the launch "
                         f"needs (sweep_buffers)")
    _sweep_launch(what, C, y, bk.pidx, bk.qidx, bk.rows, bk.wvec, bk.rvec,
                  bk.bkm, work, part, bk.wvec.shape[0], bk.wb, bk.rb, mode,
                  bk.pairs, nl, ldc, y[0].numel() if C.dim() == 2 else 0)
    _count("sn_sweep", C)
    return y



def block_trsv(D, y, wvec, bkm, *, mode, pairs=False):
    """Dense triangular solves on a bucket of diagonal blocks.

    ``D`` (k, wb, wb) packed blocks (strict lower = unit-L, diagonal =
    pivots, strict upper = U; any strides: a view of the gathered
    (k, wb+rb, wb) panel is read in place), ``y`` (k, wb) or (k, wb, m)
    right-hand sides, ``mode`` one of ``"l"``/``"lt"``/``"u"``/``"ut"``
    (see ``ref.sn_trsv_ref``).  Returns x shaped like ``y``, zero past each
    lane's width.  On CUDA it launches the sn_sweep kernel on the blocks as
    a bucket with no sub-rows."""
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown block_trsv mode {mode!r}")
    if D.device.type == "cpu":
        return _ref.sn_trsv_ref(D, y, wvec, bkm, mode=mode, pairs=pairs)
    what = "block_trsv"
    _cuda_args(what, (D, y), D.dtype)
    k, wb = D.shape[0], D.shape[1]
    vec = y.dim() == 2
    yy = y[:, :, None] if vec else y
    if tuple(D.shape) != (k, wb, wb) or yy.dim() != 3 \
            or tuple(yy.shape[:2]) != (k, wb) or not 1 <= wb <= 32:
        raise ValueError(f"{what}: D {tuple(D.shape)} / y {tuple(y.shape)} "
                         f"are not (k, wb, wb) / (k, wb[, m]) with wb <= 32")
    m = yy.shape[2]
    dev = D.device
    wv = _lane_vec(wvec, k, what, "wvec")
    bk = _lane_flags(bkm, k, wb, what)
    # D's slots from its strides (C = D's first element); rows: lane l's
    # block at rows l*wb.., its pads at the scratch row k*wb of a copy of y
    # whose pad entries are zero
    ar = torch.arange(wb, device=dev)
    s0, s1, s2 = D.stride()
    pidx = (torch.arange(k, device=dev)[:, None, None] * s0
            + ar[None, :, None] * s1 + ar[None, None, :] * s2).to(torch.int32)
    live = ar[None, :] < wv[:, None]
    rows = torch.where(live, torch.arange(k * wb, device=dev).view(k, wb),
                       k * wb).to(torch.int32)
    x = torch.zeros(k * wb + 1, m, dtype=D.dtype, device=dev)
    x[:k * wb] = torch.where(live[:, :, None], yy, 0.0).reshape(k * wb, m)
    _sweep_launch(what, D, x, pidx,
                  torch.empty(k, wb, 0, dtype=torch.int32, device=dev), rows,
                  wv, torch.zeros(k, dtype=torch.int32, device=dev), bk, None,
                  None, k, wb, 0, mode, pairs)
    LAUNCHES["sn_sweep"] += 1
    x = x[:k * wb].view(k, wb, m)
    return x[:, :, 0] if vec else x


block_trsv.passes = (2, 1)
