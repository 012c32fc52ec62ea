"""κ-gradient of the non-symmetric drift operator: BiCGStab against exact LU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_drift_study.py [ng ...]

The operator is the transposed-paths operator of ``chip_smoke.py``:
``poisson2d_vc(κ)`` with its N / S couplings scaled by 1.3 / 0.7, κ the
script's smooth random field (numpy seed 0), f = 1, loss Σu².  For each grid
(default 128, 192, 256) and in both packages, on the CPU in f64:

- ``lu``: ``backend="direct"`` (sparse LU; exact to rounding);
- ``stencil``: the stencil backend's BiCGStab at tol 1e-10, fused steps off
  and on (the port's fused loop runs the kernels' plain versions here).

It prints each BiCGStab gradient's max relative distance from the port's
LU gradient and, up to ng = 256, from the reference's own LU gradient and
the two LU gradients' distance.  Above ng = 256 the reference's direct
solve is skipped: its analysis also builds the scalar packed program it
never runs (18 GB of host memory at ng = 256).  No result of this script is
a device metric.
"""
import os
import sys
import time

import numpy as np

TOL = 1e-10
MAXITER = 30000
DRIFT = np.array([1.0, 1.3, 0.7, 1.0, 1.0]).reshape(5, 1)


def _smooth_kappa(ng, seed=0):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import smooth_kappa
    return smooth_kappa(ng, seed)


def _rel(g, ref):
    return float(np.abs(g - ref).max() / np.abs(ref).max())


def port_grads(kap):
    import torch
    from repro_torch import sla
    from repro_torch.data.poisson import vc_coefficients, vc_pattern
    ng = kap.shape[0]
    n = ng * ng
    rows, cols, meta = vc_pattern(ng)
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    f = torch.ones(n, dtype=torch.float64)
    out = {}
    for name, backend, fused in (("lu", "direct", "off"),
                                 ("stencil fused off", "stencil", "off"),
                                 ("stencil fused on", "stencil", "on")):
        k = torch.tensor(kap, requires_grad=True)
        v = (vc_coefficients(k).reshape(5, -1)
             * torch.tensor(DRIFT)).reshape(-1)
        A = sla.SparseTensor(v, rows, cols, (n, n), props=props,
                             stencil=meta if backend == "stencil" else None,
                             validate=False, device="cpu")
        t = time.perf_counter()
        with sla.options(fused_step=fused):
            u = sla.solve(A, f, backend=backend, tol=TOL, maxiter=MAXITER)
            (u * u).sum().backward()
        out[name] = (k.grad.numpy(), time.perf_counter() - t)
    return out


def reference_grads(kap, with_lu=True):
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from repro.core import options as roptions
    from repro.core.sparse import SparseTensor
    from repro.data.poisson import vc_coefficients, vc_pattern
    ng = kap.shape[0]
    n = ng * ng
    rows, cols, meta = vc_pattern(ng)
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    f = jnp.ones(n)
    out = {}
    for name, backend, fused in (("lu", "direct", "off"),
                                 ("stencil fused off", "stencil", "off"),
                                 ("stencil fused on", "stencil", "on")):
        if name == "lu" and not with_lu:
            continue

        def loss(k, backend=backend):
            v = (vc_coefficients(k).reshape(5, -1) * DRIFT).reshape(-1)
            A = SparseTensor(v, rows, cols, (n, n), props=props,
                             stencil=meta if backend == "stencil" else None,
                             validate=False)
            return jnp.sum(A.solve(f, backend=backend, tol=TOL,
                                   maxiter=MAXITER) ** 2)
        t = time.perf_counter()
        with roptions.options(fused_step=fused):
            g = np.asarray(jax.grad(loss)(jnp.asarray(kap)))
        out[name] = (g, time.perf_counter() - t)
    return out


def main(grids):
    for ng in grids:
        kap = _smooth_kappa(ng)
        res = {"port": port_grads(kap),
               "reference": reference_grads(kap, with_lu=ng <= 256)}
        exact = res["port"]["lu"][0]
        print(f"ng={ng} port      lu ({res['port']['lu'][1]:.1f} s)",
              flush=True)
        for pkg, gs in res.items():
            for name, (g, sec) in gs.items():
                if name == "lu":
                    continue
                own = (f", vs its own lu {_rel(g, gs['lu'][0]):.3e}"
                       if pkg == "reference" and "lu" in gs else "")
                print(f"ng={ng} {pkg:9s} {name:17s} vs port lu: max rel "
                      f"{_rel(g, exact):.3e}{own} ({sec:.1f} s)", flush=True)
        if "lu" in res["reference"]:
            print(f"ng={ng} lu port vs reference: max rel "
                  f"{_rel(exact, res['reference']['lu'][0]):.3e} (reference "
                  f"{res['reference']['lu'][1]:.1f} s)", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [128, 192, 256])
