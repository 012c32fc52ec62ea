"""Typed, scoped engine options (PyTorch port of ``repro.core.options``).

One immutable :class:`Options` record behind three entry points, re-exported
by :mod:`repro_torch.sla`:

* :func:`set_options` — process-wide update (``sla.set_options(fused_step="on")``);
* :func:`options` — context manager for a scoped override
  (``with sla.options(fused_step="off"): ...``), restored on exit even when
  the body raises;
* ``REPRO_SLA_*`` environment variables — read once at import, e.g.
  ``REPRO_SLA_FUSED_STEP=off`` or ``REPRO_SLA_PLAN_CACHE_BYTES=1e8``.

Every internal read goes through :func:`current` at *use* time, so overrides
apply to plans that already exist.  The fields, defaults, validation and env
spelling match the JAX package exactly; its deprecated module-global aliases
are not carried over.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional

__all__ = ["Options", "current", "set_options", "options"]


@dataclasses.dataclass(frozen=True)
class Options:
    """Engine configuration (immutable; update via :func:`set_options`).

    fused_step
        Fused CG/BiCGStab step kernels: ``"auto"`` enables them where the
        operator lies on a CUDA device and keeps the plain torch loops for
        CPU tensors; ``"on"``/``"off"`` force either path.  Read at solve
        time, never frozen into a plan.
    supernodal
        Supernodal direct factorization mode (``"auto"``/``"on"``/``"off"``)
        read by the direct backend's analysis: ``"auto"`` declines
        narrow-chain patterns (which keep the scalar packed scan), ``"off"``
        always keeps the scalar scan.
    dense_budget
        Auto-dispatch crossover: systems with ``n <= dense_budget`` take the
        dense direct path.
    direct_budget
        Auto-dispatch crossover to the sparse-direct backend.
    bell_min_fill
        Minimum block-ELL fill (nnz over padded slot capacity) for the
        analyze-time kernel plan to adopt the BELL layout on its own.
    plan_cache_cap
        Per-pattern plan cache entry bound (LRU).
    plan_cache_bytes
        Optional byte budget for the same cache; ``None`` means
        entry-count-only bounding.
    jac_coloring_budget
        Cap on Jacobian colors for sparse Newton (reference parity field).
    """
    fused_step: str = "auto"
    supernodal: str = "auto"
    dense_budget: int = 4096
    direct_budget: int = 100_000
    bell_min_fill: float = 1.0 / 64.0
    plan_cache_cap: int = 32
    plan_cache_bytes: Optional[int] = None
    jac_coloring_budget: int = 256

    def _validate(self) -> "Options":
        if self.fused_step not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_step must be 'auto'|'on'|'off', got {self.fused_step!r}")
        if self.supernodal not in ("auto", "on", "off"):
            raise ValueError(
                f"supernodal must be 'auto'|'on'|'off', got {self.supernodal!r}")
        for name in ("dense_budget", "direct_budget", "jac_coloring_budget"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{name} must be a non-negative int, got {v!r}")
        if not (0.0 <= float(self.bell_min_fill) <= 1.0):
            raise ValueError(
                f"bell_min_fill must be in [0, 1], got {self.bell_min_fill!r}")
        if not isinstance(self.plan_cache_cap, int) or self.plan_cache_cap < 1:
            raise ValueError(
                f"plan_cache_cap must be a positive int, got "
                f"{self.plan_cache_cap!r}")
        if self.plan_cache_bytes is not None and (
                not isinstance(self.plan_cache_bytes, int)
                or self.plan_cache_bytes < 0):
            raise ValueError(
                f"plan_cache_bytes must be None or a non-negative int, got "
                f"{self.plan_cache_bytes!r}")
        return self


_FIELDS = tuple(f.name for f in dataclasses.fields(Options))
ENV_PREFIX = "REPRO_SLA_"


def _parse_env(environ) -> dict:
    """``REPRO_SLA_*`` overrides as an Options kwargs dict (pure; testable).

    Integers accept float-ish spellings (``1e8``); ``plan_cache_bytes``
    additionally accepts ``none``/empty for "unbounded".  Unknown
    ``REPRO_SLA_*`` names raise — a typo'd knob must not silently no-op.
    """
    out = {}
    for key, raw in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        name = key[len(ENV_PREFIX):].lower()
        if name not in _FIELDS:
            raise ValueError(
                f"unknown option env var {key} (valid: "
                + ", ".join(ENV_PREFIX + f.upper() for f in _FIELDS) + ")")
        if name in ("fused_step", "supernodal"):
            out[name] = raw.strip().lower()
        elif name == "bell_min_fill":
            out[name] = float(raw)
        elif name == "plan_cache_bytes" and raw.strip().lower() in ("", "none"):
            out[name] = None
        else:
            out[name] = int(float(raw))
    return out


class _State(threading.local):
    """Per-thread override stack; the base (index 0) is process-wide."""

    def __init__(self):
        self.stack = [_BASE]


_BASE = Options(**_parse_env(os.environ))._validate()
_state = _State()


def current() -> Options:
    """The active :class:`Options` (innermost ``options()`` scope wins)."""
    stack = _state.stack
    # a set_options() on another thread replaces the shared base; pick it up
    # unless this thread is inside a scoped override
    if len(stack) == 1:
        stack[0] = _BASE
    return stack[-1]


def set_options(**kw) -> Options:
    """Update the process-wide options; returns the new record.

    Inside a ``with options(...)`` scope the update applies to that scope
    (and is discarded when it exits), matching the lexical intent.
    """
    global _BASE
    new = dataclasses.replace(current(), **kw)._validate()
    _state.stack[-1] = new
    if len(_state.stack) == 1:
        _BASE = new
    return new


@contextlib.contextmanager
def options(**kw):
    """Scoped override: ``with options(fused_step="on"): ...`` — restored on
    exit (exception-safe).  Yields the overridden :class:`Options`."""
    new = dataclasses.replace(current(), **kw)._validate()
    _state.stack.append(new)
    try:
        yield new
    finally:
        _state.stack.pop()
