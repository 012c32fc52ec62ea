"""Flash attention (online softmax) — wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel (or raises); on a CPU tensor it runs the plain version
``ref.flash_attention_ref``.  Bound: operations — 4·BH·S·T·d flops (halved
by the causal mask at S = T) against (q + k + v + o) bytes.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

#: launches of the CUDA kernel (plain integer; reset by the caller)
LAUNCHES = {"flash_attention": 0}
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v per batch·head, f32 inside, out in q's dtype.

    ``q``: (BH, S, d); ``k``, ``v``: (BH, T, d) with the KV heads already
    expanded to the query heads.  ``causal`` keeps key j ≤ query i (absolute
    indices, top-left aligned when T ≠ S).  Any S and T; d in
    :data:`HEAD_DIMS`; float32 or bfloat16."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device} / "
                         f"{k.device} / {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype} / {k.dtype} / "
                        f"{v.dtype} differ")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, d = q.shape
    T = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if T == 0 or BH > 65535:
        raise ValueError(f"flash_attention: needs 1 <= T and BH <= 65535, "
                         f"got T={T}, BH={BH}")
    tag = _build.cuda_dtype_tag(q.dtype, allowed=("f32", "bf16"))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if BH == 0 or S == 0:
        return o
    fn = getattr(_build.lib(), f"flash_attention_{tag}")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    BH, S, T, d, int(causal), _build.stream_ptr(q)),
                 "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
