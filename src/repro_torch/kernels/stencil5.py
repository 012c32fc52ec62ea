"""Variable-coefficient 5-point stencil SpMV — wrapper of ``csrc/stencil5.cu``.

Replaces the TPU kernel ``repro/kernels/stencil5.py::stencil5_pallas``.  On a
CUDA tensor :func:`stencil5` launches the hand-written Hopper kernel (or
raises); on a CPU tensor it runs the plain version ``ref.stencil5_ref``.
Bound: bytes — 7 words per cell (5 planes, x, y).
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel (plain integer; reset by the caller)
LAUNCHES = {"stencil5": 0}


@dataclasses.dataclass(frozen=True)
class Stencil5Meta:
    """Grid of a stencil-layout operator (the reference's TPU tiling fields
    are left out: the CUDA kernel masks the grid edges itself)."""
    nx: int
    ny: int


def stencil5(meta: Stencil5Meta, val5: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Apply the stencil.  ``val5``: (5, nx, ny) planes; ``x``: (nx, ny)."""
    if x.device.type == "cpu":
        return _ref.stencil5_ref(val5, x)
    if x.device.type != "cuda" or val5.device != x.device:
        raise ValueError(f"stencil5: tensors on {val5.device} / {x.device}")
    if val5.dtype != x.dtype:
        raise TypeError(f"stencil5: dtypes {val5.dtype} / {x.dtype} differ")
    nx, ny = meta.nx, meta.ny
    if tuple(val5.shape) != (5, nx, ny) or tuple(x.shape) != (nx, ny):
        raise ValueError(f"stencil5: shapes {tuple(val5.shape)}, "
                         f"{tuple(x.shape)} do not match grid ({nx}, {ny})")
    tag = _build.cuda_dtype_tag(x.dtype)
    val5 = val5.contiguous()
    x = x.contiguous()
    y = torch.empty_like(x)
    fn = getattr(_build.lib(), f"stencil5_{tag}")
    _build.check(fn(val5.data_ptr(), x.data_ptr(), y.data_ptr(), nx, ny,
                    _build.stream_ptr(x)), "stencil5")
    LAUNCHES["stencil5"] += 1
    return y
