"""Logical-axis sharding rules over ``DTensor`` placements (MaxText-style),
divisibility-aware.

The port of the reference's ``repro/launch/shardings.py``.  Model code
annotates activations with *logical* axis names through
``logical(x, "batch", "seq", "embed")``; a rule set maps logical names to
mesh-axis names.  Rules are installed with a context manager, so the same
model code runs unsharded (no rules, or plain tensors: ``logical`` does
nothing), on one card, and on a 16 × 16 or 2 × 16 × 16 mesh.

:meth:`Rules.axes_for` and :meth:`Rules.spec` return what the reference's
return: per tensor dimension ``None``, one mesh-axis name, or a tuple of
them.  A logical axis falls back to replication when its dimension does not
divide the product of its mesh axes — trailing axes are dropped until it
does — so 12 heads on a 16-way model axis (qwen2-1.5b) replicate.
:meth:`Rules.placements` turns a spec into one ``Placement`` a mesh
dimension: ``Shard(d)`` on each mesh axis that tensor dimension ``d`` takes
(the first axis of a tuple the outer one, as in the reference), else
``Replicate()``.  Because the spec replicates every dimension that does
not divide, a ``DTensor`` is never sharded unevenly here.  ``Rules`` reads
only ``mesh.shape[name]``: any object with a ``.shape`` mapping of axis
name to size serves for the spec logic, a ``DeviceMesh`` (whose ``shape``
is a tuple) for placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_STATE = threading.local()

Axes = Union[None, str, Sequence[str]]

#: a rule value that turns the whole constraint off (an opt-in hint that
#: must not force replication in the baseline)
SKIP = "__skip__"


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or ``mesh.shape`` itself when
    it is already such a mapping (a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(mesh.shape, dict):
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


class Rules:
    def __init__(self, mesh, table: dict):
        self.mesh = mesh
        self.table = dict(table)
        self.sizes = mesh_axis_sizes(mesh)

    def axes_for(self, name: Optional[str], dim: int) -> Axes:
        if name is None:
            return None
        ax = self.table.get(name)
        if ax is None:
            return None
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        size = 1
        for a in axes:
            size *= self.sizes[a]
        if dim % size != 0:
            # divisibility fallback: drop trailing axes until it fits
            while axes:
                axes = axes[:-1]
                size = 1
                for a in axes:
                    size *= self.sizes[a]
                if size and dim % size == 0:
                    break
            if not axes:
                return None
        return axes if len(axes) > 1 else (axes[0] if axes else None)

    def spec(self, names: Sequence[Optional[str]], shape) -> tuple:
        """Per dimension of ``shape``: None, a mesh-axis name or a tuple of
        them (the reference's ``PartitionSpec`` entries)."""
        return tuple(self.axes_for(n, d) for n, d in zip(names, shape))

    def placements(self, names: Sequence[Optional[str]], shape) -> tuple:
        """One ``Placement`` per dimension of the mesh for a tensor of
        ``shape`` with logical ``names``."""
        return spec_placements(self.mesh, self.spec(names, shape))


def spec_placements(mesh, spec) -> tuple:
    """``spec`` (per tensor dimension, None / an axis / a tuple of axes) as
    one ``Placement`` per mesh dimension.  A mesh axis named by two tensor
    dimensions raises, as a ``NamedSharding`` does, and so does a tuple
    out of the mesh's order (``DTensor`` shards a dimension over its mesh
    dimensions outer to inner in mesh order)."""
    names = tuple(mesh.mesh_dim_names)
    out = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        ax = (ax,) if isinstance(ax, str) else tuple(ax)
        if list(ax) != sorted(ax, key=names.index):
            raise ValueError(f"spec {spec}: axes {ax} out of the mesh's "
                             f"order {names}")
        for a in ax:
            if a in out:
                raise ValueError(f"mesh axis {a!r} shards dimensions "
                                 f"{out[a].dim} and {d} of spec {spec}")
            out[a] = Shard(d)
    return tuple(out.get(a, Replicate()) for a in mesh.mesh_dim_names)


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``placements`` on ``mesh``, in Python integers (the
    chunks ``DTensor`` cuts: ⌈n/parts⌉ a rank, mesh dimensions in order).
    torch's own helper builds tensors, which ``FakeTensorMode`` cannot
    read back."""
    shape, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            d, parts = p.dim, mesh.size(m)
            full = -(-shape[d] // parts)
            start = min(full * coord[m], shape[d])
            off[d] += start
            shape[d] = min(shape[d], start + full) - start
    return tuple(shape), tuple(off)


def current_rules() -> Optional[Rules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axis names.  A
    no-op without rules, on a plain tensor, on a rank mismatch, or when a
    name maps to :data:`SKIP`."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor) or x.ndim != len(names):
        return x
    if any(rules.table.get(n) == SKIP for n in names if n):
        return x
    target = rules.placements(names, x.shape)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` whole on every rank (its shards
    gathered); other placements kept.  A no-op on a plain tensor.

    The port's models make the sequence whole where a block's normed input
    enters its dense products (``models.transformer``, ``attention``,
    ``layers.Embed.logits``): a product flattens (batch, sequence), and a
    ``DTensor`` sharded on both becomes a strided shard whose
    redistribution plans take seconds to a minute an op on a 3-D mesh.
    The sequence-sharded residual stream (``seq_res``) is kept between
    blocks, as in the reference; GSPMD gathers at the same place for the
    column-parallel products."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pl = tuple(Replicate() if getattr(p, "dim", None) == dim else p
               for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def gather_params(params: dict, rules: Rules) -> dict:
    """``params`` with their shards over the batch's mesh axes (the FSDP
    axes of the rule tables: ``p_embed`` over ``data``) gathered, their
    tensor-parallel shards kept — what a step binds into its model (the
    train step a layer at a time, for the layer's forward; the serve steps
    all at once).  The gradient of a copy comes back reduce-scattered onto
    the shard."""
    dp = rules.table.get("batch") or ()
    dp = {dp} if isinstance(dp, str) else set(dp)
    names = rules.mesh.mesh_dim_names
    out = {}
    for k, t in params.items():
        if isinstance(t, DTensor):
            pl = tuple(Replicate() if names[m] in dp else p
                       for m, p in enumerate(t.placements))
            if pl != tuple(t.placements):
                t = t.redistribute(t.device_mesh, pl)
        out[k] = t
    return out


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

def baseline_rules(mesh) -> Rules:
    """Paper-faithful baseline: DP over (pod, data), TP over model,
    FSDP-style parameter sharding over data."""
    dp = ("pod", "data") if "pod" in mesh_axis_sizes(mesh) else ("data",)
    return Rules(mesh, {
        "batch": dp,
        "seq": None,
        # residual stream between blocks: sequence-sharded over the model
        # axis (Megatron sequence parallelism); falls back to replication
        # when seq < mesh (decode)
        "seq_res": "model",
        "seq_norm": SKIP,          # H5 opt-in: pin norm outputs seq-sharded
        "seq_kv": "model",         # decode KV caches: shard cache length
        "kv_heads_cache": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": None,
        # parameter axes (FSDP over data, TP over model)
        "p_embed": "data",
        "p_ff": "model",
        "p_heads": "model",
        "p_kv_heads": "model",
        "p_vocab": "model",
        "p_experts": "model",
        "p_expert_ff": None,       # EP already consumes the model axis
        "layers": None,
        # long-context sequence parallelism
        "seq_shard": dp,
        "state": "model",
    })


def make_specs(rules: Rules, names_tree, shape_tree):
    """A tree of placements from a tree of logical-name tuples and a
    parallel tree (dicts and lists) of shapes or tensors; a name tuple is a
    leaf."""
    if isinstance(names_tree, dict):
        return {k: make_specs(rules, v, shape_tree[k])
                for k, v in names_tree.items()}
    if isinstance(names_tree, list):
        return [make_specs(rules, v, s)
                for v, s in zip(names_tree, shape_tree)]
    return rules.placements(names_tree, getattr(shape_tree, "shape",
                                                shape_tree))
