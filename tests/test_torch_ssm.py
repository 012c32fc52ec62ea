"""PyTorch port vs the JAX reference: the SSD (Mamba-2) and RG-LRU mixers.

The same numpy inputs go through the reference's ``repro/models/ssm.py``
and the port's ``repro_torch/models/ssm.py``, f32: the chunked SSD core
with S not a multiple of the chunk, the sequence-decomposed SSD
(``seq_shards_mixer = 2``), the whole SSD mixer and its one-token step
against the reference's step; the RG-LRU block at S = 300 (nine doubling
passes of the port's log-depth scan against the reference's
``associative_scan``) and its step.  Tolerance 1e-5 of the output's scale
(f32 rounding of differently ordered sums).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import ssm as jssm
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import _flat
from repro_torch.models.transformer import Transformer

from _torch_parity import assert_close


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    assert_close(got, want, rtol=scale, atol=scale * np.abs(want).max())


def _module(mod, params):
    flat = {}
    _flat("", jax.tree.map(np.asarray, params), flat)
    mod.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                        strict=True)
    return mod


def _cfgs(arch, **replace):
    return (dataclasses.replace(jsmoke(jget_config(arch)), **replace),
            dataclasses.replace(smoke_variant(get_config(arch)), **replace))


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = -np.abs(f(B, S, H)) * 0.3
    return f(B, S, H, P), a, f(B, S, N), f(B, S, N)


@pytest.mark.parametrize("S,chunk", [(37, 8), (64, 16), (5, 8)])
def test_ssd_scan_matches_reference(S, chunk):
    """S % chunk ≠ 0 pads the last chunk (and S < chunk takes one chunk)."""
    Xd, a, Bm, Cm = _ssd_inputs(2, S, 3, 4, 5, S)
    h0 = np.random.default_rng(1).normal(size=(2, 3, 5, 4)).astype(
        np.float32)
    jY, jh = jssm._ssd_scan(Xd, a, Bm, Cm, chunk, h0=h0)
    Y, h = tssm._ssd_scan(*map(torch.tensor, (Xd, a, Bm, Cm)), chunk,
                          h0=torch.tensor(h0))
    assert Y.shape == (2, S, 3, 4) and h.shape == (2, 3, 5, 4)
    _close(Y, jY)
    _close(h, jh)


def _ssd_recurrence(Xd, a, Bm, Cm, h0):
    """h_t = exp(a_t)·h_{t−1} + B_t ⊗ Xd_t, y_t = C_t·h_t, step by step in
    float64 (numpy)."""
    h, ys = h0.astype(np.float64), []
    for t in range(Xd.shape[1]):
        h = (np.exp(a[:, t])[:, :, None, None] * h
             + np.einsum("bn,bhp->bhnp", Bm[:, t], Xd[:, t]))
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], h))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("S,chunk", [(300, 256), (200, 64)])
def test_ssd_scan_large_decay_matches_float64_recurrence(S, chunk):
    """mamba2-780m's decays: a = softplus(N(0, 1))·A with A from −1 to −16,
    so that the log-decay summed over a chunk reaches ~10³.  The f32 chunked scan against the float64
    recurrence at 1e-6 of the output's scale: differencing the cumulative
    sums (cum_i − cum_j) reads ~1e-5 here."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 4, 4, 8
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    a = (dt * -np.array([1.0, 4.0, 8.0, 16.0])).astype(np.float32)
    assert np.abs(np.cumsum(a[:, :chunk], 1)).max() > 700
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    Xd, Bm, Cm, h0 = f(B, S, H, P), f(B, S, N), f(B, S, N), f(B, H, N, P)
    want, wh = _ssd_recurrence(*(t.astype(np.float64)
                                 for t in (Xd, a, Bm, Cm)), h0)
    Y, h = tssm._ssd_scan(*map(torch.tensor, (Xd, a, Bm, Cm)), chunk,
                          h0=torch.tensor(h0))
    _close(Y, want, scale=1e-6)
    _close(h, wh, scale=1e-6)


def test_ssd_model_float64_decode_matches_forward():
    """The mamba2 model in f64 on the f32 model's seed-made weights (the
    same numbers): decode ≡ forward to rounding, and the f32 forward and
    decode within 1e-5 of the f64 forward."""
    cfg = dataclasses.replace(smoke_variant(get_config("mamba2-780m")),
                              dtype="float32", ssm_chunk=64)
    c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    m32 = Transformer(cfg, seed=0, device="cpu")
    m64 = Transformer(c64, seed=0, device="cpu")
    sd64 = m64.state_dict()
    assert all(torch.equal(v.double(), sd64[k])
               for k, v in m32.state_dict().items())
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 150)))

    def decode(model):
        state = model.init_decode_state(2, 150)
        return torch.cat([model.decode_step(state, toks[:, t:t + 1], t)[0]
                          for t in range(150)], 1)

    want = m64(toks)[0].detach()
    assert want.dtype == torch.float64
    _close(decode(m64), want.numpy(), scale=1e-12)
    _close(m32(toks)[0], want.numpy())
    _close(decode(m32), want.numpy())


def test_ssd_seq_parallel_matches_reference_and_scan():
    Xd, a, Bm, Cm = _ssd_inputs(2, 48, 3, 4, 5, 2)
    want = jssm._ssd_seq_parallel(Xd, a, Bm, Cm, 8, 2)
    got = tssm._ssd_seq_parallel(*map(torch.tensor, (Xd, a, Bm, Cm)), 8, 2)
    _close(got, want)
    whole, _ = tssm._ssd_scan(*map(torch.tensor, (Xd, a, Bm, Cm)), 8)
    _close(got, whole.numpy())


@pytest.mark.parametrize("n_sp", [1, 2])
def test_ssd_forward_and_step_match_reference(n_sp):
    jcfg, cfg = _cfgs("mamba2-780m", seq_shards_mixer=n_sp)
    params = jssm.init_ssd(jax.random.PRNGKey(4), jcfg)
    mod = _module(tssm.SSD(cfg, torch.Generator().manual_seed(0), "cpu"),
                  params)
    B, S = 2, 30
    x = np.random.default_rng(5).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jssm.ssd_forward(p, x, jcfg))(params, x)
    got = tssm.ssd_forward(mod, torch.tensor(x), cfg)
    _close(got, want)
    # the step, token by token, against the reference's step and the forward
    jstate = jssm.init_ssd_state(jcfg, B, np.float32)
    state = tssm.init_ssd_state(cfg, B, torch.float32, "cpu")
    jstep = jax.jit(lambda p, x, s: jssm.ssd_step(p, x, s, jcfg))
    outs = []
    for t in range(S):
        jy, jstate = jstep(params, x[:, t:t + 1], jstate)
        y, state = tssm.ssd_step(mod, torch.tensor(x[:, t:t + 1]), state,
                                 cfg)
        _close(y, jy)
        _close(state["h"], jstate["h"])
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), want, scale=1e-4)


def test_rglru_forward_and_step_match_reference():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    params = jssm.init_rglru(jax.random.PRNGKey(6), jcfg)
    mod = _module(tssm.RGLRU(cfg, torch.Generator().manual_seed(0), "cpu"),
                  params)
    B, S = 2, 300                      # ⌈log₂ 300⌉ = 9 doubling passes
    x = np.random.default_rng(8).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jssm.rglru_forward(p, x, jcfg))(params, x)
    got = tssm.rglru_forward(mod, torch.tensor(x), cfg)
    _close(got, want)
    jstate = jssm.init_rglru_state(jcfg, B, np.float32)
    state = tssm.init_rglru_state(cfg, B, torch.float32, "cpu")
    assert state["h"].dtype == torch.float32
    jstep = jax.jit(lambda p, x, s: jssm.rglru_step(p, x, s, jcfg))
    for t in range(40):
        jy, jstate = jstep(params, x[:, t:t + 1], jstate)
        y, state = tssm.rglru_step(mod, torch.tensor(x[:, t:t + 1]), state,
                                   cfg)
        _close(y, jy)
        _close(state["h"], jstate["h"])
    _close(y[:, 0], np.asarray(want)[:, 39])


def test_linear_scan_matches_sequential_recurrence():
    """The log-depth scan against the step-by-step recurrence in float64,
    at lengths around powers of two, with a near 1 (no underflow)."""
    rng = np.random.default_rng(9)
    for S in (1, 2, 3, 8, 9, 255, 256, 257):
        a = rng.uniform(0.9, 0.999, (2, S, 5))
        b = rng.normal(size=(2, S, 5))
        h, want = np.zeros((2, 5)), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = tssm.linear_scan(torch.tensor(a), torch.tensor(b))
        assert_close(got, np.stack(want, 1), rtol=1e-12, atol=1e-12)
