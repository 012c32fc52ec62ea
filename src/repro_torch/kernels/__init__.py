"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions (``ref.py``) and differentiable wrappers (``ops.py``).

Nothing here builds or loads CUDA code at import; the library is compiled by
``nvcc`` at the first launch on a CUDA tensor (``_build.py``).
"""
from . import solve_step, spmv_bell, stencil5


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset, by kernel name."""
    out = dict(stencil5.LAUNCHES)
    out.update(spmv_bell.LAUNCHES)
    out.update(solve_step.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for counts in (stencil5.LAUNCHES, spmv_bell.LAUNCHES, solve_step.LAUNCHES):
        for k in counts:
            counts[k] = 0
