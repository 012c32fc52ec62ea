"""Synthetic token pipeline (the port of the reference's
``repro/data/tokens.py``).

Deterministic and restart-safe: the batch of step ``s`` is a pure function
of (seed, s), drawn from a CPU ``torch.Generator``, so the stream is the
same on every device and a resumed run sees the batches it would have seen
— no iterator state to persist.  The construction is the reference's:
zipf-ish token ranks by an inverse CDF, and a lag-64 copy of earlier
tokens with probability ½ so that a model can lower its loss.  The numbers
differ from the reference's ``jax.random`` draws (parity tests hand the
reference's batches to both packages).
"""
from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

LAG = 64


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def synthetic_batch(seed: int, step: int, batch: int, seq: int,
                    vocab: int) -> dict:
    """``{"tokens", "labels"}`` (batch, seq − 1) int64 CPU tensors for one
    step: ``labels`` are ``tokens`` shifted by one."""
    gen = _generator(seed, step)
    u = torch.rand((batch, seq), generator=gen)
    ranks = torch.floor(torch.exp(u * math.log(float(vocab)))).to(torch.int64)
    toks = torch.clamp(ranks - 1, 0, vocab - 1)
    if seq > LAG:
        copy = torch.rand((batch, seq - LAG), generator=gen) < 0.5
        tail = torch.where(copy, toks[:, :-LAG], toks[:, LAG:])
        toks = torch.cat([toks[:, :LAG], tail], dim=1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def token_stream(seed: int, batch: int, seq: int, vocab: int,
                 start_step: int = 0) -> Iterator[dict]:
    """The batches of steps ``start_step``, ``start_step + 1``, …"""
    step = start_step
    while True:
        yield synthetic_batch(seed, step, batch, seq, vocab)
        step += 1
