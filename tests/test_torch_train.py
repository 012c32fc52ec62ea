"""PyTorch port vs the JAX reference: the training path.

One loss and gradient for every architecture's ``smoke_variant`` (the
reference's weights carried across by ``params_from_jax``, the reference's
numpy batch, CE over 2 batch chunks): loss and MoE aux to 1e-5 relative,
every parameter's gradient to 1e-4 of its max |g| against the reference's
``jax.value_and_grad(loss_fn)``.  AdamW from identical gradients: params,
m, v and lr to 1e-6.  Ten steps of the llama smoke model: losses to 1e-3
relative (Adam's first step is ≈ lr·sign(g), so updated elements whose g
is noise may flip; parameters are not compared element-wise after it).
remat ``none`` ≡ ``full`` ≡ ``dots``.  The flash backward math against
``jax.grad`` of the reference's query-chunked jnp attention at S 1536
(> 2·512, so the reference chunks): causal, bidirectional, a window, GQA.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data.tokens import synthetic_batch as jbatch
from repro.launch import train as jtrain
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import (model_from_jax, params_from_jax,
                                        state_from_jax)
from repro_torch.optim import adamw as tadamw

B, S, CHUNKS = 4, 32, 2


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jcfg = jsmoke(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = jT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params


def _batch(cfg, step=0):
    """The reference's batch of ``step`` as numpy, with random patches (their
    labels masked) for a VLM and random frames for an encoder-decoder."""
    b = {k: np.asarray(v) for k, v in
         jbatch(0, step, B, S + 1, cfg.vocab).items()}
    rng = np.random.default_rng(step)
    if cfg.vis_patches:
        P = cfg.vis_patches
        b["patches"] = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
        b["labels"] = np.concatenate(
            [-np.ones((B, P), np.int32), b["labels"]], 1)
    elif cfg.enc_dec:
        b["enc_frames"] = rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return b


def _close(got, want, scale, tol, what):
    got = got.detach().double().numpy()
    err = np.abs(got - np.asarray(want, np.float64)).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg, params = _reference(arch)
    batch = _batch(cfg)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, jcfg, b, CHUNKS), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = model_from_jax(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    total, m = ttrain.loss_fn(
        model, {k: torch.tensor(v) for k, v in batch.items()}, CHUNKS)
    total.backward()
    for k in ("loss", "moe_aux"):
        want = float(jm[k])
        assert abs(float(m[k].detach()) - want) <= 1e-5 * abs(want), \
            (k, want)
    assert float(m["tokens"]) == float(jm["tokens"])
    assert abs(float(total.detach()) - float(jtotal)) \
        <= 1e-5 * abs(float(jtotal))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, p in got.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, k
        g = want[k].numpy()
        _close(p.grad, g, np.abs(g).max(), 1e-4, k)


def _opt_case():
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "e": (3, 4, 2), "b": (5,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: 4 * rng.normal(size=s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in shapes.items()}
    v = {k: rng.uniform(size=s).astype(np.float32) * 0.01
         for k, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_matches_reference(schedule):
    """From the same params, moments, step and gradients (clipped: the
    global norm exceeds 1): params, m, v and lr to 1e-6."""
    p, g, m, v = _opt_case()
    for step in (0, 6, 30):
        cfg = dict(lr=1e-2, warmup_steps=5, total_steps=20,
                   schedule=schedule)
        jp, jst, jmet = jadamw.adamw_update(
            jadamw.AdamWConfig(**cfg), p, g,
            {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)})
        T = lambda d: {k: torch.tensor(a) for k, a in d.items()}  # noqa
        tp, tst, tmet = tadamw.adamw_update(
            tadamw.AdamWConfig(**cfg), T(p), T(g),
            {"m": T(m), "v": T(v), "step": torch.tensor(step, dtype=torch.int32)})
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= 1e-6 * cfg["lr"]
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) \
            <= 1e-6 * float(jmet["grad_norm"])
        for k in p:
            for got, want in ((tp[k], jp[k]), (tst["m"][k], jst["m"][k]),
                              (tst["v"][k], jst["v"][k])):
                want = np.asarray(want)
                assert got.dtype == torch.float32
                _close(got, want, max(np.abs(want).max(), 1e-30), 1e-6, k)


def test_ten_steps_follow_reference():
    """Ten train steps of the llama smoke model from the reference's state
    on the reference's batches: every step's loss to 1e-3 relative."""
    jcfg, cfg, params = _reference("llama3.2-1b")
    opt = dict(lr=3e-3, warmup_steps=3, total_steps=10)
    jstate = {"params": params, "opt": jadamw.init_opt_state(params)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jadamw.AdamWConfig(**opt)))
    state = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                           device="cpu")
    step = ttrain.make_train_step(cfg, tadamw.AdamWConfig(**opt))
    jl, tl = [], []
    for s in range(10):
        b = _batch(cfg, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.tensor(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-6 * opt["lr"]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert int(state["opt"]["step"]) == 10


class _CountDots(TorchDispatchMode):
    """Counts the 2-D matrix products dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads_and_backward_dots(model, batch):
    """(gradients, matrix products the backward runs)."""
    total, _ = ttrain.loss_fn(model, batch)
    with _CountDots() as c:
        total.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}, c.n


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "recurrentgemma-2b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``full`` and ``dots`` equal ``none`` to f32 rounding; the backward
    recomputes the layers' matrix products under ``full`` and not under
    ``dots`` (which saves them): it runs more of them than ``dots``, which
    runs more than ``none`` (the rest of the layer recomputed)."""
    _, cfg, params = _reference(arch)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    pnp = jax.tree.map(np.asarray, params)
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = _grads_and_backward_dots(
            model_from_jax(c, pnp, device="cpu"), batch)
    g0, n0 = out["none"]
    for remat in ("full", "dots"):
        g, _ = out[remat]
        for k, a in g0.items():
            _close(g[k], a.numpy(), float(a.abs().max()), 1e-6, (remat, k))
    assert out["full"][1] > out["dots"][1] >= n0, {k: v[1] for k, v in
                                                    out.items()}


FLASH_CASES = [  # (mode, H, K, window)
    ("causal", 4, 2, 0),
    ("bidir", 4, 4, 0),
    ("local", 4, 1, 300),
    ("causal", 6, 3, 0),
]


@pytest.mark.parametrize("mode,H,K,window", FLASH_CASES)
def test_flash_backward_matches_reference_chunked_attention(mode, H, K,
                                                            window):
    """dq, dk, dv of the port's flash attention (its autograd Function: the
    plain forward here, the blocked backward) against ``jax.grad`` of the
    reference model's query-chunked attention, f32, S 1536 in chunks of 512:
    within 1e-5 of each gradient's max |g|."""
    Bq, Sq, d = 1, 1536, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(Bq, Sq, h, d)).astype(np.float32)
               for h in (H, K, K))
    w = rng.normal(size=(Bq, Sq, H, d)).astype(np.float32)
    jcfg = jsmoke(jget_config("llama3.2-1b"))

    def jloss(q, k, v):
        o = jA._attention_chunked(q, k, v, jcfg, mode, window, 512)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = flash_attention_gqa(tq, tk, tv, causal=mode != "bidir",
                            window=window)
    # the flash op's own registered backward, not autograd through plain ops
    assert "repro_torch_flash_attention_gqa" in type(o.grad_fn).__name__
    (o * torch.tensor(w)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want)
        _close(got, want, np.abs(want).max(), 1e-5, name)
