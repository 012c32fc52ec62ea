"""The paper's own workload: 2D Poisson solve configs (Tables 3–4, Figs 2–3).

The port's copy of the reference's ``repro/configs/poisson2d.py`` (plain
data, field for field the same)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    ng: int                  # grid points per side (DOF = ng²)
    dtype: str = "float64"
    precond: str = "jacobi"
    tol: float = 1e-6
    maxiter: int = 20_000


SIZES = {                    # paper Table 3 ladder (DOF)
    "10K": PoissonConfig(ng=100),
    "100K": PoissonConfig(ng=316),
    "1M": PoissonConfig(ng=1000),
    "2M": PoissonConfig(ng=1414),
    "16M": PoissonConfig(ng=4000),
}
