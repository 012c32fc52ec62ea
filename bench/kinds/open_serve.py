"""Traffic kind ``open_serve``: independent clients, each sending one
forward solve on the shared pattern, at due times of an open-loop schedule.

One dispatcher thread serves them through the program's
``SolveServer(max_batch).submit_batch``: each time it goes idle it takes
every queued request, up to ``max_batch``, builds their operators (each its
own κ) and submits them as one wave.  A request's latency runs from its due
time to the end of its wave.  Requests due in the window are all served,
those in flight at its close drained; their latencies all count.

Mix parameters (``bench/traffic/<mix>.json``): ``rate`` (requests a
second), ``max_batch``, ``log_amplitude`` ([low, high]: each request's κ
amplitude, spread evenly over the range and shuffled), ``rhs``,
``sample_requests`` (answers compared besides the one that took the most
iterations), ``knee`` (the highest rate the sweep of
``bench/tools/sweep_knee.py`` found the backlog steady at; ``rate`` is
0.8 of it), ``order_seed`` (orders the gaps of
:func:`bench.harness.arrivals.poisson` and the amplitudes).  Every run
offers the same schedule and the same amplitudes in the same order; its
``--seed`` draws each request's κ modes and right-hand side.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.harness import arrivals
from bench.harness import check as _check
from bench.harness import inputs, program
from bench.reference import poisson_vc as ref

#: first index of the set-up wave's and the traced wave's requests
WARM = 10**9


def _inputs(run, i: int):
    """Request ``i``'s κ and right-hand side (ng, ng), in the
    configuration's precision."""
    cfg, tr = run.cell.config, run.cell.traffic
    g = inputs.generator(run.device, inputs.derive(run.seed, "request", i))
    amp = run.state["amplitudes"][i] if i < WARM else tr["log_amplitude"][1]
    kap = inputs.kappa(g, 1, cfg["grid"], cfg["kappa"], amp, run.dtype,
                       run.device)
    b = inputs.rhs(g, tr["rhs"], 1, cfg["grid"], run.dtype, run.device)
    return kap[0], b[0]


def _wave(run, ids):
    """Build the requests of ``ids`` and serve them as one wave; returns
    (results, iterations, converged, seconds inside ``submit_batch``)."""
    from repro_torch.launch.solve_serve import SolveRequest
    st = run.state
    reqs = []
    for i in ids:
        kap, b = (t.to(run.program_dtype) for t in _inputs(run, i))
        reqs.append(SolveRequest(st["A0"].with_values(program.assemble(kap)),
                                 b.reshape(-1), st["options"]))
    t = time.perf_counter()
    with run.span("submit_batch"):
        res = st["server"].submit_batch(reqs)
    inside = time.perf_counter() - t
    iters = torch.stack([r.iterations for r in res]).tolist()
    conv = torch.stack([r.converged for r in res]).tolist()
    return res, iters, conv, inside


def schedule(traffic: dict, seconds: float):
    """The due times and the requests' κ amplitudes, from the mix alone."""
    due = arrivals.poisson(traffic["rate"], seconds,
                           inputs.derive(traffic["order_seed"], "arrivals"))
    amps = arrivals.spread(traffic["log_amplitude"], len(due),
                           inputs.derive(traffic["order_seed"], "order"))
    return due, amps


def setup(run) -> None:
    from repro_torch.launch.solve_serve import SolveServer
    tr = run.cell.traffic
    run.state["due"], run.state["amplitudes"] = schedule(tr, run.seconds)
    kap0, _ = _inputs(run, WARM)
    run.state["A0"] = program.operator(run.cell.config, kap0)
    run.state["options"] = program.solver_options(run.cell.config)
    run.state["server"] = SolveServer(max_batch=tr["max_batch"])
    _wave(run, range(WARM, WARM + tr["max_batch"]))      # a full wave


def window(run) -> dict:
    tr, st = run.cell.traffic, run.state
    due = st["due"]
    n = len(due)
    sample = set(np.random.default_rng(inputs.derive(run.seed, "sample"))
                 .choice(n, min(tr["sample_requests"], n), replace=False)
                 .tolist())
    kept, slowest = {}, (-1, None, None)
    latency = np.full(n, np.nan)
    iters_all = np.zeros(n, dtype=np.int64)
    unconverged = 0
    waves, inside_s, slots = [], 0.0, 0
    stats0 = dict(st["server"].stats)
    nxt, queue = 0, []
    t0 = time.perf_counter()
    while nxt < n or queue:
        now = time.perf_counter() - t0
        while nxt < n and due[nxt] <= now:
            queue.append(nxt)
            nxt += 1
        if not queue:
            time.sleep(max(0.0, due[nxt] - now))
            continue
        ids, queue = queue[:tr["max_batch"]], queue[tr["max_batch"]:]
        pad0 = st["server"].stats["padded_slots"]
        res, iters, conv, inside = _wave(run, ids)
        done = time.perf_counter() - t0
        pad = st["server"].stats["padded_slots"] - pad0
        inside_s += inside
        slots += pad * max(iters)
        waves.append(len(ids))
        unconverged += conv.count(False)
        for i, r, it in zip(ids, res, iters):
            latency[i] = done - due[i]
            iters_all[i] = it
            if i in sample:
                kept[i] = r.x.clone()    # r.x views the whole wave
            if it > slowest[0]:
                slowest = (it, i, r.x.clone())
        del res
    if slowest[1] is not None:
        kept[slowest[1]] = slowest[2]
    st["kept"] = kept
    st["unanswered"] = int(np.isnan(latency).sum())
    st["unconverged"] = unconverged
    st["wave_sizes"] = waves
    stats = {k: v - stats0[k] for k, v in st["server"].stats.items()}
    return {"window_s": time.perf_counter() - t0, "waves": len(waves),
            "attempted": n,
            "serve_p90_ms": float(np.percentile(latency, 90) * 1e3),
            "serve": {"latency_s": latency.tolist(),
                      "useful_iters": int(iters_all.sum()),
                      "lane_slot_iters": int(slots),
                      "inside_s": inside_s, "wave_sizes": waves,
                      "server_stats": stats}}


def traced(run, i: int) -> None:
    """One wave of the window's median size, of fresh requests."""
    size = int(np.median(run.state["wave_sizes"]))
    first = WARM + run.cell.traffic["max_batch"] * (1 + i)
    ids = range(first, first + size)
    _wave(run, ids)
    run.state["traced"] = {"lanes": 1 << max(size - 1, 0).bit_length()}


def release(run) -> None:
    for key in ("A0", "options", "server"):
        run.state.pop(key, None)


def check(run):
    """(compared numbers, failed answers): the sampled requests' answers
    and the slowest one's against the plain reference, solved together;
    an unconverged or unanswered request fails."""
    cfg, st = run.cell.config, run.state
    kept = st.pop("kept")
    ids = sorted(kept)
    made = [_inputs(run, i) for i in ids]
    kap = torch.stack([m[0] for m in made])
    b = torch.stack([m[1] for m in made])
    x = torch.stack([kept[i].reshape(kap.shape[-2:]) for i in ids])
    del kept, made
    x_ref, ok = ref.solve(kap, b, cfg["solver"]["tol"],
                          cfg["solver"]["maxiter"])
    failed = st["unanswered"] + st["unconverged"] + int((~ok).sum())
    return {"x_gap": (_check.worst_gap(x, x_ref),
                      run.cell.limits["x_gap"])}, failed
