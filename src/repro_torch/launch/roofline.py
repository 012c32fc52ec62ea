"""Roofline terms of a dry-run step, and the solver-step traffic model.

The port of the reference's ``repro/launch/roofline.py``.  Three terms per
(arch × shape × mesh) cell, in seconds a card (NVIDIA H100 constants,
``launch.mesh``):

    compute    = FLOPs a rank / 989e12 (bf16 tensor-core peak)
    memory     = bytes a rank moves / 3.35e12 (HBM3)
    collective = collective bytes a rank / the link its group spans
                 (NVLink 450e9 B/s inside an 8-card node, one 400 Gb/s
                 NDR port, 50e9 B/s, between nodes)

The reference reads them from compiled XLA HLO (``parse_hlo``,
``analyze_hlo``) and compiles its unfused CG sequence through XLA to
measure its bytes (``measured_cg_baseline_bytes``); there is no HLO here,
so those three have no counterpart.  Instead :class:`StepMeter`, a
dispatch mode, watches the eager step of one rank: each op on the rank's
own tensors (``DTensor``-level ops are let through to ``DTensor``, which
runs them as local ops and collectives, so a product is counted once, at
its local size; the ops ``DTensor``'s sharding propagation runs for its
own bookkeeping are not counted), its FLOPs by torch's formulas (``flop_counter.
flop_registry``, the flash op's own included), the bytes it moves (each
input read and each output written once; views move nothing), the
collectives the program asks for (the functional collectives ``DTensor``
issues, counted by their result bytes as the reference counts HLO
collectives, never what a CPU backend substitutes for them) and the live
bytes of the rank's tensors, whose peak is the step's memory.  The
eager step materialises every op's output, so its memory term is the
unfused one — an upper bound of what a compiled step would move.
"""
from __future__ import annotations

import sys
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs.base import ModelConfig, ShapeConfig
from .mesh import CARDS_PER_NODE, HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16

#: the functional collectives, by the kind the reference's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FUNCOL = ("_c10d_functional", "_c10d_functional_autograd")
#: DTensor's sharding propagation runs ops of its own — on global-shape
#: meta tensors to infer outputs, on index tensors to cost redistributions;
#: they are bookkeeping, not the rank's work
_PROPAGATION = _sharding_prop.__file__


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename == _PROPAGATION:
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs and write nothing (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class StepMeter(TorchDispatchMode):
    """Counts one rank's work while it is entered: :attr:`flops`,
    :attr:`bytes` moved, :attr:`collectives` (kind → result bytes),
    :attr:`n_collectives`, :attr:`collective_seconds` (each collective's
    bytes over the link its group spans) and :attr:`peak_bytes` (the
    largest sum of live storages, the tensors of :meth:`hold` included).
    Only ops on the rank's own tensors count (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self.n_collectives = 0
        self.collective_seconds = 0.0
        self.live = 0
        self.peak_bytes = 0
        self._seen = set()
        self._ranks = {}

    def hold(self, tensors) -> int:
        """Count the storages of ``tensors`` (the step's arguments, held by
        the caller throughout) as live; returns their bytes."""
        before = self.live
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._track(t, forever=True)
        return self.live - before

    def _track(self, t: torch.Tensor, forever: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        if not forever:
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def _group_seconds(self, group_name, nbytes: float) -> float:
        if group_name not in self._ranks:
            pg = dist.distributed_c10d._resolve_process_group(group_name)
            ranks = dist.get_process_group_ranks(pg)
            self._ranks[group_name] = len({r // CARDS_PER_NODE
                                           for r in ranks}) == 1
        return nbytes / (NVLINK_BW if self._ranks[group_name] else IB_BW)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor run it as local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        packet = func._overloadpacket
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ns, _, name = packet._qualified_op_name.partition("::")
        kind = _COLLECTIVES.get(name) if ns in _FUNCOL else None
        if kind is not None:
            nb = float(sum(_nbytes(t) for t in outs))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + nb
            self.n_collectives += 1
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            self.collective_seconds += self._group_seconds(group, nb)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if ns not in _FUNCOL and not _is_view(func):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# solver-step traffic model (kernel plans — kernels/solve_step.py)
# ---------------------------------------------------------------------------

# HBM traffic of ONE textbook preconditioned-CG iteration's vector work, in
# vector-lengths (matvec excluded — identical on both sides).  Each pass
# streams its operands from HBM and its outputs back: an axpy is 2 reads +
# 1 write = 3n, a two-vector dot 2n, the self-dot convergence check 1n.
CG_BASELINE_PASSES: Dict[str, int] = {
    "pAp_dot": 2,         # alpha denominator  <p, Ap>
    "x_axpy": 3,          # x += alpha p
    "r_axpy": 3,          # r -= alpha Ap
    "precond_apply": 3,   # z = M r (diagonal scale)
    "rz_dot": 2,          # rho' = <r, z>
    "p_update": 3,        # p = z + beta p
    "conv_rr_dot": 1,     # loop condition recomputes <r, r>
}


def solver_step_traffic(n: int, itemsize: int = 8) -> dict:
    """Byte model: the fused CG step kernel vs the separate-pass baseline.

    The fused kernel (``kernels/solve_step.fused_cg_update``) produces
    (x', r', z') and BOTH reductions (rho', rr') in one pass — 5 reads +
    3 writes = 8n — while the merged (Chronopoulos–Gear) recurrence removes
    the standalone <p, Ap> pass outright and the carried rr removes the
    convergence re-dot.  The baseline is the seven separate memory-bound
    passes of ``CG_BASELINE_PASSES`` (17n).  The direction pass exists in
    both variants and is excluded from the ratio; full-iteration totals are
    reported alongside (14n vs 17n)."""
    from ..kernels import solve_step as _fk
    baseline = sum(CG_BASELINE_PASSES.values()) * n * itemsize
    fused = _fk.traffic_bytes(_fk.fused_cg_update, n, itemsize)
    direction = _fk.traffic_bytes(_fk.fused_cg_direction, n, itemsize)
    return {
        "baseline_bytes": float(baseline),
        "fused_step_bytes": float(fused),
        "ratio": fused / baseline,
        "iteration_fused_bytes": float(fused + direction),
        "iteration_ratio": (fused + direction) / baseline,
    }


def measured_baseline_bytes(n: int, dtype=torch.float64) -> float:
    """Bytes the UNFUSED CG pass sequence moves in eager torch, counted by
    :class:`StepMeter` on storage-free (meta) vectors: each op's inputs
    read and outputs written once.  The counterpart of the reference's
    ``measured_cg_baseline_bytes``, which counts XLA's compiled HLO."""
    def vec():
        return torch.empty(n, dtype=dtype, device="meta")

    x, r, p, s, dinv = (vec() for _ in range(5))
    rho = torch.empty((), dtype=dtype, device="meta")
    with StepMeter() as m:
        pAp = torch.dot(p, s)
        alpha = rho / pAp
        x = x + alpha * p
        r = r - alpha * s
        z = dinv * r
        rho_new = torch.dot(r, z)
        p = z + (rho_new / rho) * p
        torch.dot(r, r)
    return float(m.bytes)


def assert_fused_step_savings(n: int = 65536, threshold: float = 0.5,
                              itemsize: int = 8) -> dict:
    """Gate: the fused step's modeled bytes must stay under ``threshold``
    of the separate-pass baseline, and the unfused sequence must really
    move multi-pass traffic — at least the five output vectors' worth —
    or the "savings" would be against a strawman.  Returns the numbers."""
    model = solver_step_traffic(n, itemsize)
    if not model["ratio"] < threshold:
        raise AssertionError(
            f"fused CG step bytes {model['fused_step_bytes']:.0f} not < "
            f"{threshold}x baseline {model['baseline_bytes']:.0f} "
            f"(ratio {model['ratio']:.3f})")
    measured = measured_baseline_bytes(
        n, {4: torch.float32, 8: torch.float64}[itemsize])
    model["measured_baseline_bytes"] = measured
    floor = 5 * n * itemsize
    if not measured >= floor:
        raise AssertionError(
            f"measured unfused-baseline traffic {measured:.0f} below "
            f"plausibility floor {floor}")
    return model


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D analytic)
# ---------------------------------------------------------------------------

def active_params(cfg: ModelConfig) -> int:
    total = cfg.param_count()
    if cfg.n_experts:
        expert_p = 0
        for kind in cfg.pattern_layers:
            if kind == "moe":
                expert_p += cfg.n_experts * 3 * cfg.d_model * cfg.d_ff_expert
        active_expert = expert_p * cfg.top_k // cfg.n_experts
        return total - expert_p + active_expert
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs: 6·N·D train, 2·N·D prefill, 2·N·B decode."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# the three terms (per-card seconds)
# ---------------------------------------------------------------------------

def roofline_terms(meter: StepMeter) -> dict:
    """The three terms of one rank's step from its :class:`StepMeter`."""
    return {
        "flops_per_chip": float(meter.flops),
        "bytes_per_chip": float(meter.bytes),
        "collective_bytes_per_chip": float(sum(meter.collectives.values())),
        "t_compute_s": meter.flops / PEAK_FLOPS_BF16,
        "t_memory_s": meter.bytes / HBM_BW,
        "t_collective_s": meter.collective_seconds,
    }


def dominant_term(terms: dict) -> str:
    t = {"compute": terms["t_compute_s"], "memory": terms["t_memory_s"],
         "collective": terms["t_collective_s"]}
    return max(t, key=t.get)
