"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions (``ref.py``) and differentiable wrappers (``ops.py``).

Nothing here builds or loads CUDA code at import; the library is compiled by
``nvcc`` at the first launch on a CUDA tensor (``_build.py``).
"""
from . import flash_attention, solve_step, spmv_bell, stencil5, supernode

_COUNTERS = (stencil5.LAUNCHES, spmv_bell.LAUNCHES, solve_step.LAUNCHES,
             supernode.LAUNCHES, flash_attention.LAUNCHES)


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset, by kernel name."""
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS + (supernode.TRSV_MODE_LAUNCHES,):
        for k in counts:
            counts[k] = 0
