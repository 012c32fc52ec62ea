"""Block-ELL SpMV — wrapper of ``csrc/spmv_bell.cu``.

Replaces the TPU kernel ``repro/kernels/spmv_bell.py::bell_spmv_pallas``.
On a CUDA tensor :func:`bell_spmv` launches the hand-written Hopper kernel
(one block per row band, slot loop inside the block) or raises; on a CPU
tensor it runs the plain version ``ref.bell_matvec_ref``.  Bound: bytes —
the dense (n_rb, k, bm, bn) tiles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sparse import BellMeta
from . import _build
from . import ref as _ref

#: launches of the CUDA kernel (plain integer; reset by the caller)
LAUNCHES = {"bell_spmv": 0}


def bell_spmv(meta: BellMeta, block_cols: torch.Tensor,
              bell_vals: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """y = A @ x, truncated to ``n`` rows, with A in block-ELL form.

    ``block_cols``: (n_rb, k) int32 slot table; ``bell_vals``:
    (n_rb, k, bm, bn) tiles; ``x``: (m,) with m ≤ m_pad (no padding needed
    on CUDA: the kernel masks columns ≥ m)."""
    m = x.shape[0]
    if x.device.type == "cpu":
        xp = F.pad(x, (0, meta.m_pad - m))
        return _ref.bell_matvec_ref(bell_vals, block_cols, xp, n)
    if x.device.type != "cuda" or bell_vals.device != x.device \
            or block_cols.device != x.device:
        raise ValueError("bell_spmv: tensors must share one CUDA device")
    if bell_vals.dtype != x.dtype:
        raise TypeError(f"bell_spmv: dtypes {bell_vals.dtype} / {x.dtype}")
    if block_cols.dtype != torch.int32:
        raise TypeError(f"bell_spmv: block_cols must be int32, got "
                        f"{block_cols.dtype}")
    want = (meta.n_rb, meta.k, meta.bm, meta.bn)
    if tuple(bell_vals.shape) != want or \
            tuple(block_cols.shape) != (meta.n_rb, meta.k):
        raise ValueError(f"bell_spmv: tiles {tuple(bell_vals.shape)} / slots "
                         f"{tuple(block_cols.shape)} do not match {want}")
    if m > meta.m_pad or n > meta.n_pad or x.dim() != 1:
        raise ValueError(f"bell_spmv: x {tuple(x.shape)} / n={n} exceed the "
                         f"layout ({meta.n_pad}, {meta.m_pad})")
    tag = _build.cuda_dtype_tag(x.dtype)
    bell_vals = bell_vals.contiguous()
    block_cols = block_cols.contiguous()
    x = x.contiguous()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = getattr(_build.lib(), f"bell_spmv_{tag}")
    _build.check(fn(block_cols.data_ptr(), bell_vals.data_ptr(), x.data_ptr(),
                    y.data_ptr(), n, m, meta.n_rb, meta.k, meta.bm, meta.bn,
                    _build.stream_ptr(x)), "bell_spmv")
    LAUNCHES["bell_spmv"] += 1
    return y
