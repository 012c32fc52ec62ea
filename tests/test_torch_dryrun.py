"""The port's fake-mesh dry run (``repro_torch.launch.dryrun``), the
counterpart of ``tests/test_dryrun_small.py::test_mini_multipod_dryrun``:
one rank of a ``"fake"`` 8-rank process group on a (2, 2, 2)
pod/data/model mesh runs smoke llama3.2-1b's train step (S 64, B 8) and
decode step, and smoke mamba2-780m's train step under the ``ssm_seqpar``
variant, on storage-free stand-ins (three subprocesses side by side, each
with its own process group).  Each record has bytes, FLOPs and
``0 < useful_ratio <= 1``; the rank's train FLOPs times 8 cover the
one-device step's, and exceed it by no more than the work a rank repeats.
A sharded matmul on that mesh counts the rank's local product only.  The CLI records ``long_500k`` of a full-attention arch
as skipped, as the reference's does.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240

CELL = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.variants import VARIANTS

    arch, kind, variant = sys.argv[1:4]
    builder, transform = VARIANTS[variant]
    cfg = transform(smoke_variant(get_config(arch)))
    shape = ShapeConfig("mini", 64, 8, kind)
    with D.fake_world(8):
        mesh = init_device_mesh("cuda", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        rec = D.trace_step(cfg, shape, builder(mesh))
    if kind == "train":
        # the same step on one device, unsharded, on meta tensors
        from repro_torch.kernels.flash_attention import shape_only
        from repro_torch.launch import roofline as R, train
        from repro_torch.launch.specs import batch_specs
        from repro_torch.models.transformer import Transformer
        from repro_torch.optim.adamw import AdamWConfig
        state = train.init_state(Transformer(cfg, device="meta"))
        step = train.make_train_step(cfg, AdamWConfig())
        with shape_only(), R.StepMeter() as m:
            step(state, batch_specs(cfg, shape))
        rec["one_device_flops"] = m.flops
    print("RECORD " + json.dumps(rec))
""")

CASES = {"llama_train": ("llama3.2-1b", "train", "baseline"),
         "llama_decode": ("llama3.2-1b", "decode", "baseline"),
         "mamba_seqpar_train": ("mamba2-780m", "train", "ssm_seqpar")}
#: the most a train case's rank FLOPs × 8 may exceed the one-device step's
#: by: the work each rank repeats of its peers' (replicated norms and
#: products, the segment scan's carries under ``ssm_seqpar``).  A count that
#: took the DTensor-level ops on top of the local ones would be ≥ 2×.
MAX_REPEATED = {"llama_train": 1.2, "mamba_seqpar_train": 1.5}


@pytest.mark.parametrize("px,pw,flops", [
    # the batch over (pod, data), w's columns over model: 2·16·128·128
    (("S0", "S0", "R"), ("R", "R", "S1"), 524288),
    # x's and w's rows over model: DTensor slices x's columns, a partial
    # sum; 2·64·64·256
    (("R", "R", "S0"), ("R", "R", "S0"), 2097152)], ids=["batch_tp", "rows"])
def test_sharded_matmul_counts_the_rank_s_local_flops_only(px, pw, flops):
    """x (64 × 128) @ w (128 × 256), f32, on one rank of a fake (2, 2, 2)
    mesh under the meter: the rank's own product, with no collective — not
    the global one (4,194,304) on top."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.roofline import StepMeter
    place = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
    with D.fake_world(8):
        mesh = init_device_mesh("cuda", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        x = D.stand_in((64, 128), torch.float32, mesh,
                       [place[p] for p in px])
        w = D.stand_in((128, 256), torch.float32, mesh,
                       [place[p] for p in pw])
        with StepMeter() as m:
            x @ w
    assert (m.flops, m.n_collectives) == (flops, 0)


def test_cli_records_long_context_skip(tmp_path):
    from repro_torch.launch import dryrun
    ledger = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--mesh", "both", "--ledger", str(ledger)]) == 0
    recs = [json.loads(line) for line in ledger.read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "skipped"), ("2x16x16", "skipped")]
    # recorded cells are not run again without --force
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--ledger", str(ledger)]) == 0
    assert len(ledger.read_text().splitlines()) == 2


@pytest.fixture(scope="module", autouse=True)
def started():
    """Starts the cases' subprocesses before the module's first test, so
    that they run beside the tests that need none of them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CELL, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, args in CASES.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def records(started):
    out = {}
    for name, p in started.items():
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RECORD ")]
        out[name] = (json.loads(lines[-1][7:]) if p.returncode == 0 and lines
                     else stderr[-4000:])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mini_fake_mesh_dryrun(records, name):
    rec = records[name]
    assert isinstance(rec, dict), rec
    assert rec["chips"] == 8
    assert rec["argument_bytes"] > 0
    assert rec["peak_bytes"] >= rec["argument_bytes"]
    assert rec["bytes_per_chip"] > 0 and rec["flops_per_chip"] > 0
    assert 0 < rec["useful_ratio"] <= 1
    assert rec["n_collectives"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["t_compute_s"] > 0 and rec["t_memory_s"] > 0
    if "one_device_flops" in rec:
        # the rank's share, times the ranks, covers the whole step, and
        # repeats little of it
        one = rec["one_device_flops"]
        assert one > 0
        assert one <= rec["flops_per_chip"] * 8 <= MAX_REPEATED[name] * one
