"""Seeded inputs, made on the device.

Every input is a function of (seed, stream, index) alone, so the same seed
gives the same inputs whatever the timing, and the reference can make them
again after the window.  Conductivities κ come from the smooth family of
the configuration: a sum of ``modes`` products of sines with wavenumbers
1..``max_wavenumber``, normalised to unit peak and exponentiated at a log
amplitude (κ ∈ [e^-a, e^a])."""
from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = {"step": 1, "request": 2, "sample": 3, "arrivals": 4, "order": 5}


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one (stream, index) of a run's seed."""
    ss = np.random.SeedSequence([int(seed) % 2**64, STREAMS[stream],
                                 int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def kappa(gen: torch.Generator, lanes: int, ng: int, family: dict,
          log_amplitude, dtype, device) -> torch.Tensor:
    """(lanes, ng, ng) smooth conductivities; ``log_amplitude`` is one
    number or one per lane."""
    m, kmax = family["modes"], family["max_wavenumber"]
    wav = torch.randint(1, kmax + 1, (lanes, m, 2), generator=gen,
                        device=device).to(dtype)
    amp = torch.randn((lanes, m), generator=gen, device=device,
                      dtype=dtype) / wav.sum(-1)
    phase = torch.rand((lanes, m, 2), generator=gen, device=device,
                       dtype=dtype) * (2 * math.pi)
    t = (torch.arange(ng, device=device, dtype=dtype) + 0.5) / ng
    sx = torch.sin(math.pi * wav[..., 0, None] * t + phase[..., 0, None])
    sy = torch.sin(math.pi * wav[..., 1, None] * t + phase[..., 1, None])
    field = torch.einsum("lmi,lmj->lij", amp[..., None] * sx, sy)
    peak = field.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    a = torch.as_tensor(log_amplitude, dtype=dtype, device=device)
    a = a.reshape(-1, 1, 1) if a.dim() else a
    return torch.exp(field / peak * a)


def rhs(gen: torch.Generator, kind: str, lanes: int, ng: int, dtype,
        device) -> torch.Tensor:
    """(lanes, ng, ng) right-hand sides: ``ones`` (f ≡ 1) or ``normal``."""
    if kind == "ones":
        return torch.ones((lanes, ng, ng), dtype=dtype, device=device)
    if kind == "normal":
        return torch.randn((lanes, ng, ng), generator=gen, dtype=dtype,
                           device=device)
    raise ValueError(f"unknown right-hand side {kind!r}")
