"""The comparison that decides ``correct``, and the seeded sample of
answers it compares."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length
    (Algorithm R), drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: List[Tuple[int, object]] = []

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.size:
            self.items.append((index, item))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.size:
            self.items[j] = (index, item)


def worst_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst lane's ‖x − ref‖₂ / ‖ref‖₂ (lanes on dim 0), in float64;
    a non-finite lane reads infinity."""
    x = x.reshape(x.shape[0], -1).to(torch.float64)
    ref = ref.reshape(ref.shape[0], -1).to(torch.float64)
    gap = (x - ref).norm(dim=1) / ref.norm(dim=1)
    gap = torch.where(torch.isfinite(gap), gap,
                      torch.full_like(gap, float("inf")))
    return float(gap.max())
