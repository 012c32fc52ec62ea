"""repro_torch — PyTorch/CUDA port of the ``repro`` sparse linear algebra
engine (differentiable sparse solves behind an analyze → setup → solve plan
engine), written for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Its kernels are hand-written CUDA C++ (``kernels/csrc``),
compiled with ``nvcc`` for ``sm_90a`` at first use; on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
from . import sla
from .core.sparse import SparseTensor

__all__ = ["sla", "SparseTensor"]
