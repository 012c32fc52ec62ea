"""Device resolution shared by the port's constructors.

The port's entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and asking for CUDA where no card is
visible raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build the "
            "tensor on the CPU (the plain-PyTorch kernel versions run there)")
    return dev


def to_numpy(a):
    """Host numpy view of a tensor, array or sequence (indices, values)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
