"""Fake-mesh dry run: show, with no card, that the distribution config is
coherent, and read its roofline terms.

The port of the reference's ``repro/launch/dryrun.py``.  For every
(architecture × input shape) cell, on the single-pod 16 × 16 mesh (256
ranks) and the 2 × 16 × 16 multi-pod mesh (512), the cell's step — one
train step, one prefill or one decode step — runs as ONE rank of that
mesh: a ``"fake"`` process group of the mesh's world size (its collectives
return at once), the state and inputs as ``DTensor``\\ s whose local shards
are storage-free ``device="meta"`` tensors placed by the logical-axis
rules, and the flash kernel's fake implementation
(``kernels.flash_attention.shape_only``).  ``launch.roofline.StepMeter``
records the rank's argument bytes, its peak of live bytes, FLOPs, bytes
moved and collectives; from them come ``model_flops``, ``useful_ratio``
and the three ``t_*`` terms with the ``dominant`` one.  Results append to
a JSONL ledger.  ``long_500k`` is skipped (and recorded as such) for the
pure full-attention archs, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The mesh is a ``cuda`` mesh, the card the trace stands for; no card is
needed, since the shards are meta tensors (fake CUDA tensors would not
do on a CPU build of torch, which lacks the CUDA device guard that index,
gather and embedding backward take).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

DEFAULT_LEDGER = os.path.join("results", "torch_dryrun.jsonl")


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process being ``rank``, for the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def stand_in(shape, dtype, mesh, placements) -> DTensor:
    """A ``DTensor`` of global ``shape`` on ``placements`` whose local shard
    is a meta tensor (no storage)."""
    from .shardings import local_shape_and_offset
    local, _ = local_shape_and_offset(shape, mesh, placements)
    shape = torch.Size(shape)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _stand_ins(tree, mesh, placements, dtype_of):
    if isinstance(tree, dict):
        return {k: _stand_ins(v, mesh, placements[k], dtype_of)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stand_ins(v, mesh, p, dtype_of)
                for v, p in zip(tree, placements)]
    return stand_in(getattr(tree, "shape", tree), dtype_of(tree), mesh,
                    placements)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def trace_step(cfg, shape, rules) -> dict:
    """Run ``shape``'s step of ``cfg`` as this rank of ``rules.mesh`` on
    stand-ins and return its record: argument and peak bytes, FLOPs,
    collectives, model FLOPs, ``useful_ratio`` and the roofline terms."""
    from ..kernels.flash_attention import shape_only
    from ..models.layers import pdtype
    from ..models.transformer import param_shapes
    from ..optim.adamw import AdamWConfig
    from . import roofline as R
    from .serve import jit_prefill, jit_serve_step
    from .specs import batch_specs, decode_specs
    from .train import BATCH_AXES, jit_train_step

    mesh = rules.mesh
    chips = mesh.size()
    pshapes = param_shapes(cfg)
    pdt = pdtype(cfg)
    t0 = time.time()
    if shape.kind == "train":
        specs = batch_specs(cfg, shape)
        step, state_pl = jit_train_step(cfg, AdamWConfig(), rules, pshapes,
                                        specs)
        dtypes = {"params": pdt, "m": torch.float32, "v": torch.float32}
        state = {"params": _stand_ins(pshapes, mesh, state_pl["params"],
                                      lambda _: pdt),
                 "opt": {k: _stand_ins(pshapes, mesh, state_pl["opt"][k],
                                       lambda _, k=k: dtypes[k])
                         for k in ("m", "v")}}
        state["opt"]["step"] = stand_in((), torch.int32, mesh,
                                        state_pl["opt"]["step"])
        batch = {k: stand_in(v.shape, v.dtype, mesh, rules.placements(
            BATCH_AXES[k], v.shape)) for k, v in specs.items()}
        args = _leaves(state) + _leaves(batch)

        def run():
            step(state, batch)
    elif shape.kind == "prefill":
        specs = batch_specs(cfg, shape)
        specs.pop("labels")
        prefill, p_pl = jit_prefill(cfg, rules, pshapes)
        params = _stand_ins(pshapes, mesh, p_pl, lambda _: pdt)
        batch = {k: stand_in(v.shape, v.dtype, mesh, rules.placements(
            BATCH_AXES[k], v.shape)) for k, v in specs.items()}
        args = _leaves(params) + _leaves(batch)

        def run():
            prefill(params, **batch)
    else:
        dspecs = decode_specs(cfg, shape)
        step, (p_pl, c_pl) = jit_serve_step(cfg, rules, pshapes, dspecs)
        params = _stand_ins(pshapes, mesh, p_pl, lambda _: pdt)
        state = _stand_ins(dspecs["state"], mesh, c_pl, lambda t: t.dtype)
        token = stand_in((shape.global_batch, 1), torch.int32, mesh,
                         rules.placements(("batch", None),
                                          (shape.global_batch, 1)))
        args = _leaves(params) + _leaves(state) + [token]

        def run():
            step(params, state, token, shape.seq_len - 1)
    meter = R.StepMeter()
    arg_bytes = meter.hold(args)
    with shape_only(), meter:
        run()
    terms = R.roofline_terms(meter)
    mf = R.model_flops(cfg, shape)
    global_flops = terms["flops_per_chip"] * chips
    rec = dict(
        chips=chips,
        n_params=sum(math.prod(s) for s in pshapes.values()),
        trace_s=round(time.time() - t0, 1),
        argument_bytes=int(arg_bytes),
        peak_bytes=int(meter.peak_bytes),
        bytes_per_device=int(meter.peak_bytes),
        collectives=meter.collectives,
        n_collectives=meter.n_collectives,
        model_flops=mf,
        useful_ratio=(mf / global_flops) if global_flops else None,
        **terms)
    rec["dominant"] = R.dominant_term(terms)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             variant: str = "baseline") -> dict:
    """One cell as rank 0 of a fake 256- or 512-rank world (set up and torn
    down here: the default process group must not exist yet)."""
    from ..configs import SHAPES, get_config, is_subquadratic
    from .mesh import make_production_mesh
    from .variants import VARIANTS

    rules_builder, cfg_transform = VARIANTS[variant]
    cfg = cfg_transform(get_config(arch))
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "rules": variant, "kind": shape.kind}
    if shape_name == "long_500k" and not is_subquadratic(cfg):
        rec.update(status="skipped",
                   reason="pure full-attention arch — quadratic at 524k")
        return rec
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(status="ok", **trace_step(cfg, shape, rules_builder(mesh)))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--ledger", default=DEFAULT_LEDGER)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the ledger")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS, SHAPES

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.ledger) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.ledger) and not args.force:
        with open(args.ledger) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("rules", "baseline")))
                except json.JSONDecodeError:
                    pass

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape, mesh_name, args.variant) in done:
                    continue
                print(f"=== {arch} × {shape} × {mesh_name} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, variant=args.variant)
                except Exception as e:      # a cell's failure is its record
                    if dist.is_initialized():
                        dist.destroy_process_group()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "rules": args.variant, "status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "trace": traceback.format_exc()[-2000:]}
                with open(args.ledger, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "error"
                if st == "ok":
                    print(f"  traced {rec['trace_s']}s | args "
                          f"{rec['argument_bytes'] / 2**30:.2f} GiB, peak "
                          f"{rec['peak_bytes'] / 2**30:.2f} GiB/dev | "
                          f"t_comp {rec['t_compute_s'] * 1e3:.2f} ms "
                          f"t_mem {rec['t_memory_s'] * 1e3:.2f} ms "
                          f"t_coll {rec['t_collective_s'] * 1e3:.2f} ms "
                          f"→ {rec['dominant']} | useful "
                          f"{(rec['useful_ratio'] or 0) * 100:.0f}%",
                          flush=True)
                else:
                    print(f"  {st}: {rec.get('reason', rec.get('error'))}",
                          flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
