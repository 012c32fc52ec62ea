"""Bounded sub-windows under ``torch.profiler``, reduced to numbers.

One step or wave runs under the device activity alone: its device
intervals (kernels, copies, sets) merged give the busy time, its host time
the window.  Another runs with the host's events too, which slow the host
down: the gaps between its device intervals are put down to the innermost
host event that covers each gap's middle (the span ``bench.traced`` wraps
the call)."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

TOP = 10          # entries of each breakdown list
WINDOW = "bench.traced"


def short(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    for noise in ("(anonymous namespace)::", "void "):
        name = name.replace(noise, "")
    return name.split("(", 1)[0][:120]


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(device: List[Tuple[int, int, str]],
           host: List[Tuple[int, int, str]]) -> dict:
    """Busy time, window, time by kernel and idle gaps by host activity,
    from (start_ns, end_ns, name) events of the device and the host."""
    win = [(s, e) for s, e, n in host if n == WINDOW]
    if not win:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win[0]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in device
           if e > w0 and s < w1]
    busy = merged([(s, e) for s, e, _ in dev])
    by_kernel: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_kernel[short(n)] += (e - s) / 1e9
    inner = sorted((s, e, n) for s, e, n in host if n != WINDOW)
    starts = [s for s, _, _ in inner]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        what = "no host event"
        for j in range(i, max(i - 200, -1), -1):
            if inner[j][1] >= mid:
                what = short(inner[j][2])
                break
        gaps[what] += (b - a) / 1e9
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": dict(by_kernel),
        "device_ops": [[k, v] for k, v in top[:TOP]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def _events(fn, sync, activities):
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as _profile
    from torch.profiler import supported_activities
    # a CPU-only build rehearses with the host's activity alone
    activities = [a for a in activities if a in supported_activities()] \
        or [ProfilerActivity.CPU]
    sync()
    with _profile(activities=activities) as prof:
        t = time.perf_counter()      # the profiler's own start left out
        with record_function(WINDOW):
            fn()
            sync()
        wall = time.perf_counter() - t
    return prof.profiler.kineto_results.events(), wall


def profile_device(fn: Callable[[], None], sync: Callable[[], None]) -> dict:
    """Run ``fn`` once under the profiler's device activity alone (no host
    events, so the host runs at its own pace) and reduce it: busy time,
    time by kernel; the window is the call's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    evs, wall = _events(fn, sync, [ProfilerActivity.CUDA])
    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in evs if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()]
    lo = min((s for s, _, _ in device), default=0)
    hi = max((e for _, e, _ in device), default=0)
    r = reduce(device, [(lo, max(hi, lo + int(wall * 1e9)), WINDOW)])
    r["window_s"] = wall
    del r["idle_gaps"]
    return r


def profile_gaps(fn: Callable[[], None], sync: Callable[[], None]) -> list:
    """Run ``fn`` once under the profiler's host and device activity and
    return its idle gaps by host activity (the host runs slower here, so
    only where the gaps fall is read from this run, not their share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    evs, _ = _events(fn, sync, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    device, host = [], []
    for e in evs:
        item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():     # a span's device-side copy
                device.append(item)
        elif e.device_type() == DeviceType.CPU and item[2]:
            host.append(item)
    return reduce(device, host)["idle_gaps"]
