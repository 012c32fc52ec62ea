"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; a
reference tensor crosses to the port as numpy arrays through
``repro_torch.core.convert`` (the port itself never imports the reference).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.convert import sparse_from_arrays

CPU = "cpu"


def tol(dtype):
    """Kernel parity tolerances (the reference's test_kernels ``_tol``)."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else
            dict(rtol=1e-12, atol=1e-12))


def port_of(A_ref, device=CPU):
    """The port's SparseTensor for a reference SparseTensor."""
    d = {"val": np.asarray(A_ref.val), "row": np.asarray(A_ref.row),
         "col": np.asarray(A_ref.col), "shape": A_ref.shape,
         "props": dict(A_ref.props)}
    if A_ref.stencil is not None:
        d["stencil"] = (A_ref.stencil.nx, A_ref.stencil.ny)
    return sparse_from_arrays(d, device=device)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, **kw):
    np.testing.assert_allclose(np_of(a), np_of(b), **kw)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels have no CPU build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels only run on the "
                    "card (their plain versions are tested on the CPU)")
    return torch.device("cuda")
