"""Block-ELL SpMV — wrapper of ``csrc/spmv_bell.cu``.

Replaces the TPU kernel ``repro/kernels/spmv_bell.py::bell_spmv_pallas``.
The matrix is the one a block-ELL plan describes (``core.sparse.build_bell``:
slot table and ``perm``), but the card reads it in the sliced-ELL form built
from that plan in the same analyze pass (``core.sparse.SellLayout``): slices
of 32 rows, each padded to its longest row, one warp per slice and one lane
per row.  The dense (n_rb, k, bm, bn) tiles were the TPU's operand shape;
here they would move ~50x the bytes the nonzeros need.  On a CUDA tensor
:func:`bell_spmv` launches the hand-written Hopper kernel or raises; on a
CPU tensor it runs the plain version ``ref.sell_matvec_ref``.  Bound: bytes
— 12 B per padded entry (f64 value, int32 column) plus x read and y written.

Lanes (the reference's ``jax.vmap`` of the kernel, written out), through
one lane-batched kernel that reads each slot's column once for a chunk of
lanes and applies it to all of them: :func:`bell_spmv_batched` (B value
arrays on one pattern, times B right-hand sides or one) and
:func:`bell_spmm` (one value array times k right-hand sides).  The chunk
size is a compile-time accumulator count (1, 2, 4 or 8);
:func:`lane_chunks` splits B into such chunks, all run by one launch.  Lane
b's sum keeps the single-vector kernel's order, so it equals
:func:`bell_spmv` on lane b bit for bit.
"""
from __future__ import annotations

import torch

from ..core.sparse import SellLayout
from . import _build
from . import ref as _ref

#: launches of the CUDA kernel (plain integer; reset by the caller)
LAUNCHES = {"bell_spmv": 0, "bell_spmv_batched": 0, "bell_spmm": 0}


def bell_spmv(sell: SellLayout, vals: torch.Tensor, x: torch.Tensor,
              n: int) -> torch.Tensor:
    """y = A @ x, the first ``n`` rows, with A in sliced-ELL form.

    ``vals``: (n_slots,) the layout's values (``ops.sell_assemble``);
    ``x``: (m,).  Rows past the layout's last entry are 0."""
    if x.device.type == "cpu":
        return _ref.sell_matvec_ref(sell.slice_ptr, sell.cols, vals, x, n)
    if x.device.type != "cuda" or vals.device != x.device \
            or sell.cols.device != x.device:
        raise ValueError("bell_spmv: tensors must share one CUDA device")
    if vals.dtype != x.dtype:
        raise TypeError(f"bell_spmv: dtypes {vals.dtype} / {x.dtype}")
    if tuple(vals.shape) != (sell.n_slots,) or x.dim() != 1:
        raise ValueError(f"bell_spmv: values {tuple(vals.shape)} / x "
                         f"{tuple(x.shape)} do not match {sell.n_slots} slots")
    if not 0 <= n <= sell.n_rows:
        raise ValueError(f"bell_spmv: n={n} exceeds the layout's "
                         f"{sell.n_rows} rows")
    tag = _build.cuda_dtype_tag(x.dtype)
    vals = vals.contiguous()
    x = x.contiguous()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = getattr(_build.lib(), f"bell_spmv_{tag}")
    _build.check(fn(sell.slice_ptr.data_ptr(), sell.cols.data_ptr(),
                    vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                    _build.stream_ptr(x)), "bell_spmv")
    LAUNCHES["bell_spmv"] += 1
    return y


#: lanes a thread of the lane kernel carries: its compile-time chunk sizes
LANE_CHUNKS = (8, 4, 2, 1)


def lane_chunks(lanes: int) -> list:
    """The chunks the lane kernel splits ``lanes`` lanes into, as (chunk
    size, chunks) pairs, largest first: as many 8-lane chunks as fit, then
    one chunk per binary digit of the rest (20 → 2 × 8 + 4; 15 → 8 + 4 + 2
    + 1), so no thread carries an accumulator it does not use.  One launch
    runs them all; it is built for the first size and derives the rest."""
    full, rest = divmod(lanes, LANE_CHUNKS[0])
    out = [(LANE_CHUNKS[0], full)] if full else []
    return out + [(c, 1) for c in LANE_CHUNKS[1:] if rest & c]


def _launch_lanes(name, sell, vals, x, n, lanes, val_stride, x_stride):
    if x.device.type != "cuda" or vals.device != x.device \
            or sell.cols.device != x.device:
        raise ValueError(f"{name}: tensors must share one CUDA device")
    if vals.dtype != x.dtype:
        raise TypeError(f"{name}: dtypes {vals.dtype} / {x.dtype}")
    if vals.shape[-1] != sell.n_slots:
        raise ValueError(f"{name}: values {tuple(vals.shape)} do not match "
                         f"{sell.n_slots} slots")
    if not 0 <= n <= sell.n_rows:
        raise ValueError(f"{name}: n={n} exceeds the layout's "
                         f"{sell.n_rows} rows")
    tag = _build.cuda_dtype_tag(x.dtype)
    vals = vals.contiguous()
    x = x.contiguous()
    y = x.new_empty(lanes, n)
    fn = getattr(_build.lib(), f"bell_spmv_lanes_{tag}")
    if lanes and n:                     # else the kernel has nothing to do
        _build.check(fn(sell.slice_ptr.data_ptr(), sell.cols.data_ptr(),
                        vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, lanes,
                        lane_chunks(lanes)[0][0], val_stride, x_stride,
                        _build.stream_ptr(x)), name)
        LAUNCHES[name] += 1
    return y


def bell_spmv_batched(sell: SellLayout, vals: torch.Tensor, x: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Y[b] = A_b @ x_b for B value arrays on one sliced-ELL pattern.

    ``vals``: (B, n_slots); ``x``: (B, m), or (m,) shared by every lane.
    Returns (B, n)."""
    if vals.dim() != 2 or x.dim() not in (1, 2) or (
            x.dim() == 2 and x.shape[0] != vals.shape[0]):
        raise ValueError(f"bell_spmv_batched: values {tuple(vals.shape)} / x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols, vals,
                                          x, n)
    return _launch_lanes("bell_spmv_batched", sell, vals, x, n,
                         vals.shape[0], sell.n_slots,
                         x.shape[-1] if x.dim() == 2 else 0)


def bell_spmm(sell: SellLayout, vals: torch.Tensor, X: torch.Tensor,
              n: int) -> torch.Tensor:
    """Y[j] = A @ X[j] for k right-hand sides: ``vals`` (n_slots,), ``X``
    (k, m).  Returns (k, n).  Each value and column is read once for a
    chunk of right-hand sides (:func:`lane_chunks`) and applied to each of
    them; one launch for all k."""
    if vals.dim() != 1 or X.dim() != 2:
        raise ValueError(f"bell_spmm: values {tuple(vals.shape)} / X "
                         f"{tuple(X.shape)}")
    if X.device.type == "cpu":
        return _ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols, vals,
                                          X, n)
    return _launch_lanes("bell_spmm", sell, vals, X, n, X.shape[0], 0,
                         X.shape[1])
