"""Traffic kind ``closed_grad``: one client in a closed loop, each step a
batch of ``batch`` problem instances with fresh seeded conductivities.

A step is what a training loop over PDE instances pays: assemble the
values from κ (``A0.with_values(vc_coefficients(κ))``), ``sla.solve``, and
``backward()`` of Σu² to ∂/∂κ, then wait for the gradient.  The window runs
steps until ``seconds`` have passed; it ends at the last completed step.
Each step's outputs may be drawn, by a reservoir seeded from the run, for
the comparison with the plain reference after the window.

Mix parameters (``bench/traffic/<mix>.json``): ``batch`` (lanes a step;
1 runs the unbatched call), ``log_amplitude`` (κ's), ``rhs`` (``ones`` or
``normal``), ``sample_steps`` (steps compared), ``peak_steps`` (the
allocator's peak is read after this many steps of the window, or at its
end if it runs fewer: the same work in every run, however fast).
"""
from __future__ import annotations

import time

import torch

from bench.harness import check as _check
from bench.harness import inputs, program
from bench.reference import poisson_vc as ref

#: index of the set-up step's inputs, outside any window's range
WARM = 10**9


def _kappa(run, k: int) -> torch.Tensor:
    cfg, tr = run.cell.config, run.cell.traffic
    g = inputs.generator(run.device, inputs.derive(run.seed, "step", k))
    kap = inputs.kappa(g, tr["batch"], cfg["grid"], cfg["kappa"],
                       tr["log_amplitude"], run.dtype, run.device)
    f = inputs.rhs(g, tr["rhs"], tr["batch"], cfg["grid"], run.dtype,
                   run.device)
    return kap, f


def _step(run, k: int):
    from repro_torch import sla
    st = run.state
    kap, f = (t.to(run.program_dtype) for t in _kappa(run, k))
    if run.cell.traffic["batch"] == 1:
        kap, f = kap[0], f[0]
    kap.requires_grad_(True)
    with run.span("assemble"):
        A = st["A0"].with_values(program.assemble(kap))
    with run.span("solve"):
        u = sla.solve(A, f.reshape(f.shape[:-2] + (-1,)), **st["options"])
    loss = (u * u).sum()
    with run.span("backward"):
        loss.backward()
    run.sync()
    return u.detach(), kap.grad, loss.detach()


def setup(run) -> None:
    kap0, _ = _kappa(run, WARM)
    run.state["A0"] = program.operator(run.cell.config, kap0[0])
    run.state["options"] = program.solver_options(run.cell.config)
    _step(run, WARM)                 # analyze, kernels, allocator: warm


def window(run) -> dict:
    tr = run.cell.traffic
    keep = _check.Reservoir(tr["sample_steps"],
                            inputs.derive(run.seed, "sample"))
    losses = []
    t0 = time.perf_counter()
    k = 0
    while True:
        u, g, loss = _step(run, k)
        keep.offer(k, (u, g))
        losses.append(loss)
        k += 1
        if k == tr["peak_steps"] and run.device.type == "cuda":
            run.state["peak_bytes"] = torch.cuda.max_memory_allocated(
                run.device)
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
    run.state["kept"] = keep.items
    run.state["losses"] = torch.stack(losses)
    return {"window_s": elapsed, "steps": k,
            "step_ms": elapsed / k * 1e3,
            "attempted": k * tr["batch"]}


def traced(run, i: int) -> None:
    run.state["traced"] = {"lanes": run.cell.traffic["batch"]}
    _step(run, WARM + 1 + i)


def release(run) -> None:
    for key in ("A0", "options"):
        run.state.pop(key, None)


def check(run):
    """(compared numbers, failed answers): every kept step's lanes against
    the plain reference, solved together; a non-finite loss anywhere in the
    window fails its step."""
    cfg, tr = run.cell.config, run.cell.traffic
    losses = run.state.pop("losses")
    failed = int((~torch.isfinite(losses)).sum()) * tr["batch"]
    kept = run.state.pop("kept")
    made = [_kappa(run, k) for k, _ in kept]
    kap = torch.cat([m[0] for m in made])
    f = torch.cat([m[1] for m in made])
    ng = cfg["grid"]
    u = torch.cat([v[0].reshape(-1, ng, ng) for _, v in kept])
    g = torch.cat([v[1].reshape(-1, ng, ng) for _, v in kept])
    del kept, made
    u_ref, g_ref, ok = ref.solve_and_grad(kap, f, cfg["solver"]["tol"],
                                          cfg["solver"]["maxiter"])
    failed += int((~ok).sum())
    lim = run.cell.limits
    return {"u_gap": (_check.worst_gap(u, u_ref), lim["u_gap"]),
            "grad_gap": (_check.worst_gap(g, g_ref), lim["grad_gap"])}, \
        failed
