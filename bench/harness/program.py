"""The program under test, as a user calls it: the operator's pattern built
once, values assembled from κ by the program's own differentiable
assembly, and the solver options the configuration states."""
from __future__ import annotations

import torch


def operator(config: dict, kappa0: torch.Tensor):
    """The configuration's operator for κ₀ (ng, ng).  ``stencil``: the
    program's stencil-layout constructor; ``coo``: the same matrix handed
    over as a general COO tensor (no stencil metadata), so that the solve
    dispatches as it would for any sparse matrix."""
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import (poisson2d_vc, vc_coefficients,
                                          vc_pattern)
    if config["layout"] == "stencil":
        return poisson2d_vc(kappa0, use_stencil_kernel=True,
                            device=kappa0.device)
    if config["layout"] == "coo":
        ng = kappa0.shape[-1]
        rows, cols, _ = vc_pattern(ng)
        return SparseTensor(vc_coefficients(kappa0), rows, cols,
                            (ng * ng, ng * ng),
                            props={"symmetric": True, "spd_hint": True,
                                   "sorted_rows": False},
                            validate=False, device=kappa0.device)
    raise ValueError(f"unknown layout {config['layout']!r}")


def assemble(kappa: torch.Tensor) -> torch.Tensor:
    """Signed planes of κ (..., ng, ng), flattened, by the program."""
    from repro_torch.data.poisson import vc_coefficients
    return vc_coefficients(kappa)


def solver_options(config: dict) -> dict:
    """The options the user passes; ``backend`` is left to dispatch."""
    s = config["solver"]
    return {"method": s["method"], "precond": s["precond"],
            "tol": s["tol"], "maxiter": s["maxiter"]}
