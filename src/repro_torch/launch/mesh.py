"""Device meshes and the hardware constants of the roofline terms.

The port of the reference's ``repro/launch/mesh.py``.  Functions, not
module-level meshes: importing this module creates no process group and
touches no device.  A mesh is a ``torch.distributed`` ``DeviceMesh`` under
the reference's axis names over the default process group, which the
caller initialises (NCCL on cards, gloo on the CPU, the ``"fake"`` backend
for the dry run).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the production meshes: one pod of 16 × 16 cards, or two of them
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 × 16 = 256 cards a pod (``data``, ``model``); with ``multi_pod``
    2 × 16 × 16 = 512 (``pod``, ``data``, ``model``).  The default process
    group must hold exactly that many ranks."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(n: int = 1, axes=("data",)) -> DeviceMesh:
    """A small mesh for tests and examples: ``n`` ranks on one axis, or
    ``n`` a tuple with one size per name of ``axes``."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=tuple(axes))


# NVIDIA H100 SXM (NVIDIA's H100 data sheet; dense rates without sparsity,
# at the full 700 W power limit), per card
HBM_BW = 3.35e12                 # bytes/s, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
HBM_BYTES = 80e9                 # device memory
# NVLink 4 inside an 8-card HGX H100 node: 900 GB/s of total bandwidth a
# card, 450 GB/s in each direction (NVIDIA's H100 data sheet)
NVLINK_BW = 450e9
CARDS_PER_NODE = 8
# between nodes: one ConnectX-7 400 Gb/s NDR InfiniBand port a card
# (NVIDIA DGX H100 user guide: eight single-port NDR adapters), 50 GB/s in
# each direction.  A 16-way mesh axis spans two nodes, so its collectives
# are bound by this rate.
IB_BW = 400e9 / 8
