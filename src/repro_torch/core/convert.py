"""Carry a matrix across from the reference package as plain arrays.

The port imports nothing of the JAX package; a caller that holds a
reference ``SparseTensor`` hands its arrays over as numpy (e.g.
``np.asarray(A.val)``) in a dict, and :func:`sparse_from_arrays` builds the
port's tensor from them::

    d = {"val": ..., "row": ..., "col": ..., "shape": (n, m),
         "props": {...}, "stencil": (nx, ny)}      # stencil optional

``props`` crosses as it is, the routing hints included: ``illcond_hint``
(auto-dispatch prefers the direct backend up to 4× ``direct_budget``) and
``indefinite_hint`` (the direct backend's analysis places static 2x2 pivot
blocks).  Without ``props`` the properties are detected from the arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .sparse import SparseTensor


def sparse_from_arrays(d: dict, device=None) -> SparseTensor:
    """The port's :class:`SparseTensor` for the arrays in ``d``."""
    stencil = None
    if d.get("stencil") is not None:
        from ..kernels.stencil5 import Stencil5Meta
        nx, ny = d["stencil"]
        stencil = Stencil5Meta(nx=int(nx), ny=int(ny))
    props = d.get("props")
    return SparseTensor(np.asarray(d["val"]), np.asarray(d["row"]),
                        np.asarray(d["col"]), tuple(d["shape"]),
                        props=None if props is None else dict(props),
                        stencil=stencil, device=device)


def kappa_from_array(a, device=None, requires_grad: bool = False
                     ) -> torch.Tensor:
    """κ (ng, ng) as a leaf tensor on ``device`` (for ``poisson2d_vc``)."""
    t = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    return t.requires_grad_(requires_grad)
