"""Fault-tolerant training driver (the port of the reference's
``repro/ft/driver.py``).

Wraps a step function with periodic (optionally asynchronous)
checkpointing, crash/restart recovery — resume from the newest atomic
checkpoint; the data stream is a pure function of the step, so no iterator
state is lost — straggler detection (an EWMA of the step time; a step over
``straggler_factor`` times it is logged and recorded) and failure
injection for tests.  Checkpoints hold whole (unsharded) arrays, and a
restart may restore onto another device (``device=``).  A step is timed up
to ``torch.cuda.synchronize`` of the state's device when it is a card.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from ..checkpoint.manager import CheckpointManager, _flatten


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    straggler_factor: float = 3.0       # step > factor × EWMA ⇒ flag
    max_restarts: int = 3


class SimulatedFailure(RuntimeError):
    pass


def _first_tensor(tree):
    return next(v for v in _flatten(tree).values()
                if isinstance(v, torch.Tensor))


class TrainLoop:
    def __init__(self, cfg: FTConfig, step_fn: Callable,
                 make_batch: Callable, device=None):
        """``step_fn(state, batch) -> (state, metrics)``;
        ``make_batch(step) -> batch`` must be pure in ``step``; ``device``:
        where a restart restores the state (None: where it was)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.device = device
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                     async_save=cfg.async_save)
        self.straggler_log: list = []
        self._ewma: Optional[float] = None

    def run(self, state, num_steps: int, start_step: int = 0,
            fail_at: Optional[int] = None, log_every: int = 10,
            logger=print):
        """Returns (state, last step).  ``fail_at`` injects one failure.
        A failure before the first checkpoint restarts from ``state`` as
        given (the reference keeps the advanced state there and so applies
        the steps already taken twice)."""
        initial = state
        step = start_step
        restarts = 0
        failed_once = False
        while step < num_steps:
            try:
                while step < num_steps:
                    if fail_at is not None and step == fail_at \
                            and not failed_once:
                        failed_once = True
                        raise SimulatedFailure(f"injected at step {step}")
                    t0 = time.perf_counter()
                    batch = self.make_batch(step)
                    state, metrics = self.step_fn(state, batch)
                    leaf = _first_tensor(state)
                    if leaf.device.type == "cuda":
                        torch.cuda.synchronize(leaf.device)
                    dt = time.perf_counter() - t0
                    self._track_straggler(step, dt, logger)
                    step += 1
                    if step % self.cfg.ckpt_every == 0 or step == num_steps:
                        self.mgr.save(step, state,
                                      {"metrics": _to_py(metrics)})
                    if log_every and step % log_every == 0:
                        logger(f"step {step}: "
                               + " ".join(f"{k}={_fmt(v)}"
                                          for k, v in metrics.items())
                               + f" ({dt * 1e3:.0f} ms)")
                break
            except SimulatedFailure as e:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                latest = self.mgr.latest_step()
                logger(f"[ft] failure: {e}; restarting from checkpoint "
                       f"step {latest}")
                if latest is not None:
                    self.mgr.wait()
                    state = self.mgr.restore(latest, state, self.device)
                    step = latest
                else:
                    state, step = initial, start_step
        self.mgr.wait()
        return state, step

    def _track_straggler(self, step: int, dt: float, logger):
        if self._ewma is None:
            self._ewma = dt
        elif dt > self.cfg.straggler_factor * self._ewma and step > 5:
            self.straggler_log.append((step, dt, self._ewma))
            logger(f"[ft] straggler: step {step} took {dt * 1e3:.0f} ms "
                   f"(EWMA {self._ewma * 1e3:.0f} ms)")
        self._ewma = 0.9 * (self._ewma or dt) + 0.1 * dt


def _to_py(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _fmt(v):
    try:
        return f"{float(v):.4g}"
    except (TypeError, ValueError):
        return str(v)
