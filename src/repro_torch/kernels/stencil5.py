"""Variable-coefficient 5-point stencil SpMV — wrapper of ``csrc/stencil5.cu``.

Replaces the TPU kernel ``repro/kernels/stencil5.py::stencil5_pallas``.  On a
CUDA tensor :func:`stencil5` launches the hand-written Hopper kernel (or
raises); on a CPU tensor it runs the plain version ``ref.stencil5_ref``.
Bound: bytes — 7 words per cell (5 planes, x, y).  :func:`stencil5_batched`
runs the same kernel over lanes (the grid's z axis): B operators times B
right-hand sides, or one operator times k; lane b equals :func:`stencil5`
on lane b bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel (plain integer; reset by the caller)
LAUNCHES = {"stencil5": 0, "stencil5_batched": 0}


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


def stencil5_batched(meta: Stencil5Meta, val5: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Apply the stencil over lanes.  ``val5``: (B, 5, nx, ny) planes, or
    (5, nx, ny) shared by every lane; ``x``: (B, nx, ny), or (nx, ny) when
    the planes are lane-batched.  Returns (B, nx, ny)."""
    nx, ny = meta.nx, meta.ny
    if val5.shape[-3:] != (5, nx, ny) or x.shape[-2:] != (nx, ny) \
            or val5.dim() not in (3, 4) or x.dim() not in (2, 3) \
            or (val5.dim() == 3 and x.dim() == 2) \
            or (val5.dim() == 4 and x.dim() == 3
                and val5.shape[0] != x.shape[0]):
        raise ValueError(f"stencil5_batched: shapes {tuple(val5.shape)}, "
                         f"{tuple(x.shape)} on grid ({nx}, {ny})")
    if x.device.type == "cpu":
        return _ref.stencil5_lanes_ref(val5, x)
    if x.device.type != "cuda" or val5.device != x.device:
        raise ValueError(f"stencil5_batched: tensors on {val5.device} / "
                         f"{x.device}")
    if val5.dtype != x.dtype:
        raise TypeError(f"stencil5_batched: dtypes {val5.dtype} / {x.dtype}")
    lanes = val5.shape[0] if val5.dim() == 4 else x.shape[0]
    tag = _build.cuda_dtype_tag(x.dtype)
    val5 = val5.contiguous()
    x = x.expand(lanes, nx, ny).contiguous()
    y = torch.empty_like(x)
    fn = getattr(_build.lib(), f"stencil5_lanes_{tag}")
    _build.check(fn(val5.data_ptr(), x.data_ptr(), y.data_ptr(), nx, ny,
                    lanes, 5 * nx * ny if val5.dim() == 4 else 0,
                    _build.stream_ptr(x)), "stencil5_batched")
    LAUNCHES["stencil5_batched"] += 1
    return y
