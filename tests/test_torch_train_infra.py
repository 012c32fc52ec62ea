"""The training substrate of the PyTorch port: the reference's
``tests/test_train.py`` cases on the port (loss decreases, checkpoint
round-trip and bitwise resume, FT failure injection, keep-k atomicity,
data determinism, restore onto a device, int8 round-trip with error
feedback), a reference checkpoint resumed in the port through
``state_from_jax``, and the int8 collectives on two gloo ranks (own
segment exact, halos within scale/2 of the neighbour's values, zeros at
the ends; the sum within P·scale/2 of the exact one).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data.tokens import synthetic_batch as jbatch
from repro.launch import train as jtrain
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.distributed import make_mesh
from repro_torch.data.tokens import synthetic_batch
from repro_torch.ft.driver import FTConfig, SimulatedFailure, TrainLoop
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import state_from_jax
from repro_torch.models.transformer import Transformer
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamWConfig

from _torch_parity import run_two_ranks

RANK_TIMEOUT = 120


def _setup(lr=3e-3, steps=40):
    cfg = smoke_variant(get_config("llama3.2-1b"))
    state = ttrain.init_state(Transformer(cfg, seed=0, device="cpu"))
    step = ttrain.make_train_step(
        cfg, AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps))
    return cfg, state, step, lambda s: synthetic_batch(0, s, 4, 65, cfg.vocab)


def _leaves(state):
    return [state["params"][k] for k in sorted(state["params"])] + [
        state["opt"][m][k] for m in ("m", "v")
        for k in sorted(state["opt"][m])] + [state["opt"]["step"]]


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_loss_decreases():
    cfg, state, step, make_batch = _setup()
    losses = []
    for s in range(40):
        state, m = step(state, make_batch(s))
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::8]


def test_checkpoint_roundtrip_and_resume_equivalence(tmp_path):
    """Stop at step 10, restore, continue to 20: bitwise equal to an
    uninterrupted run; the state handed to a step is left as it was."""
    cfg, state0, step, make_batch = _setup()
    first = {k: v.clone() for k, v in state0["params"].items()}
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    state = state0
    for s in range(10):
        state, _ = step(state, make_batch(s))
    mgr.save(10, state)
    cont = state
    for s in range(10, 20):
        cont, _ = step(cont, make_batch(s))
    resumed = mgr.restore(10, state0)
    assert int(resumed["opt"]["step"]) == 10
    for s in range(10, 20):
        resumed, _ = step(resumed, make_batch(s))
    _assert_equal(cont, resumed)
    for k, v in first.items():
        assert torch.equal(state0["params"][k], v), k


def test_ft_failure_injection_recovers(tmp_path):
    cfg, state, step, make_batch = _setup()
    logs = []
    loop = TrainLoop(FTConfig(ckpt_dir=str(tmp_path / "ft"), ckpt_every=5,
                              async_save=False), step, make_batch)
    final, last = loop.run(state, 20, fail_at=12, log_every=0,
                           logger=logs.append)
    assert last == 20 and loop.mgr.latest_step() == 20
    assert any("restarting from checkpoint step 10" in m for m in logs)
    assert loop.mgr.manifest(20)["metrics"]["loss"] > 0
    loop2 = TrainLoop(FTConfig(ckpt_dir=str(tmp_path / "ft2"), ckpt_every=5),
                      step, make_batch)
    final2, _ = loop2.run(state, 20, log_every=0, logger=lambda *_: None)
    _assert_equal(final, final2)


def test_ft_gives_up_after_max_restarts(tmp_path):
    cfg, state, step, make_batch = _setup()

    def failing(state, batch):
        raise SimulatedFailure("always")

    loop = TrainLoop(FTConfig(ckpt_dir=str(tmp_path / "ft"), max_restarts=2),
                     failing, make_batch)
    with pytest.raises(SimulatedFailure):
        loop.run(state, 3, log_every=0, logger=lambda *_: None)


def test_checkpoint_keep_k_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "k"), keep=2, async_save=True)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    r = mgr.restore(4, tree)
    assert torch.equal(r["a"], torch.arange(5))
    assert torch.equal(r["b"]["c"], torch.ones((2, 2)))
    assert not [d for d in os.listdir(tmp_path / "k") if d.startswith(".tmp")]
    with open(tmp_path / "k" / "step_4" / "manifest.json") as f:
        assert json.load(f)["n_arrays"] == 2
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, {"a": torch.zeros(4), "b": tree["b"]})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(4, {"z": torch.zeros(1)})


def test_checkpoint_bf16_roundtrip(tmp_path):
    """A bf16 tensor is saved as its int16 bit pattern, listed in the
    manifest, and restored as the same bf16 values."""
    tree = {"p": torch.randn(3, 5).to(torch.bfloat16),
            "o": {"m": torch.randn(3, 5), "step": torch.tensor(7)}}
    mgr = CheckpointManager(str(tmp_path / "bf"), keep=1)
    mgr.save(1, tree)
    assert mgr.manifest(1)["bfloat16"] == ["p"]
    back = mgr.restore(1, tree)
    assert back["p"].dtype == torch.bfloat16
    assert torch.equal(back["p"], tree["p"])
    assert torch.equal(back["o"]["m"], tree["o"]["m"])
    assert int(back["o"]["step"]) == 7


def test_ft_config_default_dir_is_under_the_temp_dir():
    import tempfile
    d = FTConfig().ckpt_dir
    assert os.path.isabs(d)
    assert os.path.commonpath([d, tempfile.gettempdir()]) == \
        tempfile.gettempdir()


def test_ft_failure_before_first_checkpoint_restarts_from_given_state(
        tmp_path):
    """With ``ckpt_every`` past the failure there is no checkpoint to
    resume: the loop restarts from the state ``run`` was given, so its
    final state equals an uninterrupted run's (no step applied twice)."""
    cfg, state, step, make_batch = _setup()
    logs = []
    loop = TrainLoop(FTConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=10,
                              async_save=False), step, make_batch)
    final, last = loop.run(state, 6, fail_at=3, log_every=0,
                           logger=logs.append)
    assert last == 6
    assert any("checkpoint step None" in m for m in logs)
    loop2 = TrainLoop(FTConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=10,
                               async_save=False), step, make_batch)
    final2, _ = loop2.run(state, 6, log_every=0, logger=lambda *_: None)
    _assert_equal(final, final2)


def test_data_determinism_and_restart_safety():
    b1 = synthetic_batch(0, 7, 4, 200, 1000)
    b2 = synthetic_batch(0, 7, 4, 200, 1000)
    b3 = synthetic_batch(0, 8, 4, 200, 1000)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 199)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    t = torch.cat([b1["tokens"], b1["labels"][:, -1:]], 1)
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    # about half of positions 64–127 copy the (uncopied) token 64 back
    same = (t[:, 64:128] == t[:, :64]).float().mean()
    assert 0.4 < float(same) < 0.7
    # zipf-ish: small ranks are the common ones
    assert float((t < 10).float().mean()) > 0.25


def test_restore_onto_a_device(tmp_path):
    """Checkpoints store whole host arrays: a restore places them on the
    device asked for (a card when there is one), in the template's dtypes."""
    mgr = CheckpointManager(str(tmp_path / "e"), keep=1)
    tree = {"w": torch.arange(16.0).reshape(4, 4),
            "step": torch.tensor(3, dtype=torch.int32)}
    mgr.save(3, tree)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    r = mgr.restore(3, tree, device=dev)
    assert r["w"].device.type == dev and r["step"].dtype == torch.int32
    assert torch.equal(r["w"].cpu(), tree["w"])
    r = mgr.restore(3, {"w": torch.zeros((4, 4), dtype=torch.float64),
                        "step": tree["step"]})
    assert r["w"].dtype == torch.float64


def test_int8_quantization_roundtrip_and_error_feedback():
    x = torch.tensor(np.random.default_rng(0).normal(size=512) * 3.0)
    q, s = compress.quantize_int8(x)
    assert q.dtype == torch.int8
    err0 = float((compress.dequantize_int8(q, s) - x).abs().max())
    assert err0 <= float(s) * 0.5 + 1e-9
    err = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    for _ in range(50):
        q, s, err = compress.ef_compress(x, err)
        acc = acc + compress.dequantize_int8(q, s)
    np.testing.assert_allclose((acc / 50).numpy(), x.numpy(),
                               atol=float(s) * 0.1)


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The reference trains 4 steps of the llama smoke model and saves; its
    checkpoint's arrays, unflattened, become the port's state
    (``state_from_jax``); both continue 4 steps on the reference's batches:
    losses to 1e-3 relative."""
    jcfg = jsmoke(jget_config("llama3.2-1b"))
    cfg = smoke_variant(get_config("llama3.2-1b"))
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=8)
    params = jT.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jadamw.init_opt_state(params)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))

    def batch(s):
        return {k: np.asarray(v) for k, v in
                jbatch(0, s, 4, 65, cfg.vocab).items()}

    for s in range(4):
        jstate, _ = jstep(jstate, batch(s))
    JManager(str(tmp_path / "ref"), keep=1).save(4, jstate)
    with np.load(tmp_path / "ref" / "step_4" / "arrays.npz") as z:
        tree = {}
        for key in z.files:
            *path, leaf = key.split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    state = state_from_jax(cfg, tree, device="cpu")
    assert int(state["opt"]["step"]) == 4
    step = ttrain.make_train_step(cfg, AdamWConfig(**opt))
    jl, tl = [], []
    for s in range(4, 8):
        b = batch(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.tensor(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


# ---------------------------------------------------------------------------
# the int8 collectives over torch.distributed
# ---------------------------------------------------------------------------

P, N_LOC, H_LO, H_HI = 4, 12, 3, 2


def _stack():
    rng = np.random.default_rng(5)
    return rng.normal(size=(P, N_LOC)) * rng.uniform(0.5, 4.0, (P, 1))


def _collectives(group):
    """The rank's rows of the compressed sum and halo exchange."""
    mesh = make_mesh(P, group=group, device="cpu")
    x = torch.tensor(_stack())[mesh.shards]
    return {"psum": compress.compressed_psum(x, mesh).numpy(),
            "halo": compress.compressed_halo_exchange(
                x, H_LO, H_HI, mesh).numpy()}


def _gloo_rank(rank, store_path, out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    try:
        np.savez(f"{out_path}.{rank}.npz", **_collectives(dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def _check_collectives(psums, halo):
    x = _stack()
    scales = np.abs(x).max(1) / 127.0
    for s in psums:
        assert np.abs(s - x.sum(0)).max() <= P * scales.max() / 2 + 1e-12
    assert halo.shape == (P, H_LO + N_LOC + H_HI)
    np.testing.assert_array_equal(halo[:, H_LO:H_LO + N_LOC], x)
    assert not halo[0, :H_LO].any() and not halo[-1, H_LO + N_LOC:].any()
    for p in range(1, P):
        lo = halo[p, :H_LO] - x[p - 1, -H_LO:]
        assert np.abs(lo).max() <= scales[p - 1] / 2 + 1e-12, p
    for p in range(P - 1):
        hi = halo[p, H_LO + N_LOC:] - x[p + 1, :H_HI]
        assert np.abs(hi).max() <= scales[p + 1] / 2 + 1e-12, p


def test_compressed_collectives_one_process():
    out = _collectives(None)
    _check_collectives([out["psum"]], out["halo"])


def test_compressed_collectives_on_two_gloo_ranks(tmp_path):
    out_path = run_two_ranks(_gloo_rank, tmp_path, "out", RANK_TIMEOUT)
    got = [dict(np.load(f"{out_path}.{r}.npz")) for r in range(2)]
    np.testing.assert_array_equal(got[0]["psum"], got[1]["psum"])
    np.testing.assert_array_equal(got[0]["psum"], _collectives(None)["psum"])
    _check_collectives([g["psum"] for g in got],
                       np.concatenate([g["halo"] for g in got]))
