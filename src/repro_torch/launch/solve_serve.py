"""Solve-as-a-service: a request-batching driver over the plan engine (port
of the reference's ``repro/launch/solve_serve.py``).

Serving traffic is thousands of concurrent solves on a handful of sparsity
patterns — the amortization the plan engine was built for.  The driver
turns a stream of independent ``(A, b)`` requests into grouped, batched
dispatches:

1. **group** requests by plan key — shared pattern (the tensors' plan-cache
   identity) + resolved :class:`SolverConfig`;
2. **pad** each group's stacked values / right-hand sides to the next power
   of two by repeating the first lane (the reference's padding: the same
   ``stats`` and ``occupancy``, and at most log2(max_batch) batch shapes per
   group);
3. **dispatch** ONE batched ``plan.solve`` per group — one analyze per
   pattern (``PLAN_STATS["analyze"]``), one batched setup per dispatch
   (``setup_batch``), one lane-batched Krylov loop on the lane-batched
   kernels.  Nothing is compiled ahead: the loop is the same Python loop a
   single solve runs.

The CLI runs the serving workload and prints the report; it runs on the
card unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.solve_serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import dispatch as _dispatch
from ..core._device import resolve_device
from ..core.dispatch import PLAN_STATS, make_config
from ..core.solvers import SolveResult
from ..core.sparse import SparseTensor


@dataclasses.dataclass
class SolveRequest:
    """One serving request: a values-carrying tensor, a right-hand side, and
    per-request solver options (``backend``/``method``/``precond``/``tol``/
    ``atol``/``maxiter``).  Requests sharing a pattern (``with_values``
    views of one tensor) and options land in the same dispatch group."""
    A: SparseTensor
    b: torch.Tensor
    options: dict = dataclasses.field(default_factory=dict)


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class SolveServer:
    """Groups, pads, and dispatches solve requests as batched solves.

    Stateless between batches except for the plan caches living on the
    request tensors themselves.  ``stats`` tracks dispatch counts and
    batch-group occupancy (real requests over padded slots — the padding
    overhead the power-of-two policy trades for a bounded set of shapes).
    """

    def __init__(self, max_batch: int = 64):
        self.max_batch = max_batch
        self.stats = {"dispatches": 0, "requests": 0, "padded_slots": 0}

    @property
    def occupancy(self) -> float:
        """Real requests / padded batch slots across all dispatches so far."""
        slots = self.stats["padded_slots"]
        return self.stats["requests"] / slots if slots else 1.0

    def _plan_for(self, req: SolveRequest):
        cfg = make_config(req.A, **req.options)
        return _dispatch.get_plan(req.A, cfg), cfg

    def submit_batch(self, requests: List[SolveRequest]) -> List[SolveResult]:
        """Solve a wave of requests; results come back in request order.

        Groups by (pattern identity, resolved config), pads each group's
        stacked values / right-hand sides to a power of two by repeating
        the first lane, and runs one batched ``plan.solve`` per group.
        Per-request diagnostics are sliced back out of the stacked
        ``SolveInfo`` (one host read of the converged flags per group)."""
        groups: Dict[tuple, dict] = {}
        for idx, req in enumerate(requests):
            plan, cfg = self._plan_for(req)
            key = (id(getattr(req.A, "_plans", None)), cfg)
            g = groups.setdefault(key, {"plan": plan, "cfg": cfg,
                                        "members": []})
            g["members"].append((idx, req))

        results: List[Optional[SolveResult]] = [None] * len(requests)
        for g in groups.values():
            plan, cfg, members = g["plan"], g["cfg"], g["members"]
            for start in range(0, len(members), self.max_batch):
                chunk = members[start:start + self.max_batch]
                k = len(chunk)
                pad = _pow2(k)
                first = chunk[0][1]
                vals = torch.stack([r.A.val for _, r in chunk]
                                   + [first.A.val] * (pad - k))
                bs = torch.stack([r.b for _, r in chunk]
                                 + [first.b] * (pad - k))
                xs, info = plan.solve(plan.matrix(vals), bs, cfg=cfg)
                self.stats["dispatches"] += 1
                self.stats["requests"] += k
                self.stats["padded_slots"] += pad
                converged = info.converged.tolist()
                for lane, (idx, _) in enumerate(chunk):
                    results[idx] = SolveResult(
                        x=xs[lane], iterations=info.iters[lane],
                        residual=info.resnorm[lane],
                        converged=info.converged[lane],
                        reason="converged" if converged[lane] else "maxiter")
        return results


# ---------------------------------------------------------------------------
# serving workload + report
# ---------------------------------------------------------------------------

def _workload(n_requests: int, grid: int, n_patterns: int, seed: int,
              options: dict, device) -> List[SolveRequest]:
    """Shared-pattern request stream: ``n_patterns`` Poisson grids
    (``grid``, ``grid + 1``, ...), each request a scaled-values view (same
    pattern, different values, scale in [0.7, 1.4] from numpy ``seed``)
    with a random right-hand side — the traffic the plan engine amortizes."""
    from ..data.poisson import poisson2d
    rng = np.random.default_rng(seed)
    bases = [poisson2d(grid + i, device=device) for i in range(n_patterns)]
    reqs = []
    for i in range(n_requests):
        A0 = bases[i % n_patterns]
        scale = float(rng.uniform(0.7, 1.4))   # similar conditioning: the
        Ai = A0.with_values(A0.val * scale)    # lanes stay near-lockstep
        bi = torch.as_tensor(rng.normal(size=A0.shape[0]),
                             dtype=A0.val.dtype, device=A0.device)
        reqs.append(SolveRequest(Ai, bi, dict(options)))
    return reqs


def _latencies(lat) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3)}


def serve(n_requests: int = 64, grid: int = 20, n_patterns: int = 1,
          max_batch: int = 32, seed: int = 0, check: bool = True,
          device=None, **solve_options) -> dict:
    """Run the serving workload; return the metrics report.

    Times two drivers over the SAME request stream and plans: the batched
    server (grouped + padded + batched dispatch, the stream consumed in
    ``max_batch`` waves) and the one-at-a-time loop (one single solve per
    request on the request pattern's cached plan).  Reports p50/p99 request
    latency, solves/s for both, their ratio, batch-group occupancy and the
    plan counters.  Both drivers warm up first (one wave, one request per
    pattern), off the clock.  ``check=True`` holds every batched solution to
    the sequential one (rtol 1e-6, atol 1e-8).  ``device`` defaults to the
    card."""
    dev = resolve_device(device)
    solve_options.setdefault("backend", "jnp")
    solve_options.setdefault("method", "cg")
    solve_options.setdefault("precond", "jacobi")
    solve_options.setdefault("tol", 1e-8)

    _dispatch.reset_plan_stats()
    requests = _workload(n_requests, grid, n_patterns, seed, solve_options,
                         dev)
    server = SolveServer(max_batch=max_batch)

    def single(req):
        plan, cfg = server._plan_for(req)
        return plan.solve(plan.matrix(req.A.val), req.b, cfg=cfg)

    # warm-up off the clock: the plans' analyses, the kernels' build
    server.submit_batch(requests[:max_batch])
    for req in requests[:n_patterns]:
        single(req)
    _sync(dev)

    lat_batched, out_batched = [], []
    t0 = time.perf_counter()
    for start in range(0, len(requests), max_batch):
        wave = requests[start:start + max_batch]
        res = server.submit_batch(wave)
        _sync(dev)
        lat_batched.extend([time.perf_counter() - t0] * len(wave))
        out_batched.extend(res)
    t_batched = time.perf_counter() - t0

    lat_seq, out_seq = [], []
    t0 = time.perf_counter()
    for req in requests:
        x, info = single(req)
        _sync(dev)
        lat_seq.append(time.perf_counter() - t0)
        out_seq.append((x, info))
    t_seq = time.perf_counter() - t0

    if check:
        for res, (x_ref, _) in zip(out_batched, out_seq):
            np.testing.assert_allclose(res.x.cpu().numpy(),
                                       x_ref.cpu().numpy(),
                                       rtol=1e-6, atol=1e-8)

    n = len(requests)
    return {
        "n_requests": n,
        "n_patterns": n_patterns,
        "grid": grid,
        "max_batch": max_batch,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "batched": {"total_s": t_batched, "solves_per_sec": n / t_batched,
                    **_latencies(lat_batched)},
        "sequential": {"total_s": t_seq, "solves_per_sec": n / t_seq,
                       **_latencies(lat_seq)},
        "speedup": t_seq / t_batched,
        "occupancy": server.occupancy,
        "plan_stats": dict(PLAN_STATS),
        "converged": bool(all(r.reason == "converged" for r in out_batched)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="64 requests on one 20x20 grid")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--patterns", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="jnp")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kw = dict(n_requests=args.requests, grid=args.grid,
              n_patterns=args.patterns, max_batch=args.max_batch,
              seed=args.seed, device=args.device, backend=args.backend)
    if args.smoke:
        kw.update(n_requests=64, grid=20, n_patterns=1)
    rep = serve(**kw)
    b, s = rep["batched"], rep["sequential"]
    print(f"requests={rep['n_requests']} patterns={rep['n_patterns']} "
          f"grid={rep['grid']} max_batch={rep['max_batch']} "
          f"device={rep['device']}")
    print(f"batched    : {b['solves_per_sec']:8.1f} solves/s  "
          f"p50={b['p50_ms']:.2f} ms  p99={b['p99_ms']:.2f} ms")
    print(f"sequential : {s['solves_per_sec']:8.1f} solves/s  "
          f"p50={s['p50_ms']:.2f} ms  p99={s['p99_ms']:.2f} ms")
    print(f"speedup={rep['speedup']:.2f}x  occupancy={rep['occupancy']:.2f}  "
          f"analyze={rep['plan_stats']['analyze']} "
          f"(converged={rep['converged']})")
    return rep


if __name__ == "__main__":
    main()
