"""One run of one cell: set-up, the measured window, an optional traced
sub-window, the comparison with the plain reference, and the result line.

The module of the cell's traffic kind does the cell's own work through five
functions: ``setup(run)`` builds the program's state and warms the cell's
path, ``window(run)`` measures for ``run.seconds`` and returns the window's
readings, ``traced(run, i)`` runs one more step or wave (the ``i``-th) for the
profiler,
``release(run)`` frees the program's state, and ``check(run)`` returns the
compared numbers as ``{name: (value, limit)}`` and the count of failed
answers."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from . import cell as _cell
from . import trace as _trace


@dataclasses.dataclass
class Run:
    cell: _cell.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    #: the precision the program runs at: the configuration's, unless a
    #: control switches the program's lower-precision path on
    program_dtype: Optional[torch.dtype] = None
    state: dict = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(list))

    def __post_init__(self):
        if self.program_dtype is None:
            self.program_dtype = self.dtype

    @property
    def dtype(self) -> torch.dtype:
        """The configuration's precision: inputs and the reference."""
        return getattr(torch, self.cell.config["dtype"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A synchronised host-clock span, recorded in traced runs only (an
        untraced run adds no synchronisation to the timed path)."""
        if not self.trace:
            yield
            return
        self.sync()
        t = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.sync()
        self.spans[name].append(time.perf_counter() - t)


def counters() -> dict:
    """The program's launch counts and plan counters, copied."""
    from repro_torch import kernels
    from repro_torch.core.dispatch import PLAN_STATS
    return {"launches": dict(kernels.launch_counts()),
            "plan": dict(PLAN_STATS)}


def delta(after: dict, before: dict) -> dict:
    return {group: {k: v - before[group].get(k, 0)
                    for k, v in after[group].items()}
            for group in after}


def problem(run: Run) -> dict:
    cfg = run.cell.config
    return {"ng": cfg["grid"], "n": cfg["grid"] ** 2,
            "layout": cfg["layout"],
            "itemsize": torch.empty((), dtype=run.program_dtype)
            .element_size(),
            "lanes": run.cell.traffic.get("batch", 1)}


def execute(cell: _cell.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            program_dtype: Optional[torch.dtype] = None) -> dict:
    """Run the cell; return the result object (without the module check,
    which the caller makes last).  ``program_dtype`` runs the program at
    another precision than the configuration's (the control)."""
    run = Run(cell, seed, seconds, trace, device, program_dtype)
    drv = _cell.kind_module(cell)
    drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    c0 = counters()
    readings = drv.window(run)
    run.sync()
    readings["counters"] = delta(counters(), c0)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # a kind may read the peak after a fixed amount of its window's work
    peak_metric = run.state.pop("peak_bytes", peak)
    traced: Optional[dict] = None
    if trace:
        c1 = counters()
        traced = _trace.profile_device(lambda: drv.traced(run, 0), run.sync)
        traced["counters"] = delta(counters(), c1)
        traced.update(run.state.get("traced", {}))
        traced["idle_gaps"] = _trace.profile_gaps(lambda: drv.traced(run, 1),
                                                  run.sync)
    drv.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = drv.check(run)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    readings.update(spans=dict(run.spans), problem=problem(run),
                    trace=traced)
    if trace:
        metrics = {}
        read = _cell.readers(cell)
        for m in cell.per_layer:
            value = read[m["name"]].read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        readings["setup_s"] = setup_s
        readings["peak_mem_gb"] = peak_metric / 1e9
        metrics = {m["name"]: {"value": readings[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": bool(correct),
              "attempted": int(readings["attempted"]),
              "failed": int(failed),
              "metrics": metrics,
              "device": device_info(device, peak, traced)}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def device_info(device: torch.device, peak: int,
                traced: Optional[dict]) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak),
                "power_limit": power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if traced is not None:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it (or why not)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread: {exc.__class__.__name__}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"
