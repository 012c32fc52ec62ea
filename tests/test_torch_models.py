"""PyTorch port vs the JAX reference: the LM of every registry architecture.

For each architecture's ``smoke_variant`` (f32), the reference's
``init_params`` crosses to the port as numpy through
``models.convert.params_from_jax`` (one reference init per architecture);
the port's ``forward`` logits must equal the reference's — dense scores
(B 2, S 24) and ``last_only`` at rtol = atol = 1e-5 for the dense decoders,
at 1e-4 of max |logits| for the MoE, recurrent, SSD and encoder-decoder
models, whose sums (routing gathers, scans, the encoder) are ordered
differently; the reference's query-chunked path (B 1, S 1536) for the
dense decoders and its chunked local band for recurrentgemma — and its
``decode_step`` must equal the reference's step by step and its own
``forward`` at the reference test's 5e-4; the MoE aux to 1e-6 relative.
whisper takes random encoder frames.  qwen2-vl also takes prefix patches
and 3-section M-RoPE positions; a vocab that is not a multiple of 256 takes
the padded unembedding.  The port's attention core is the card's route on
every device (one flash-wrapper call per attention sub-layer on the
projections' own layout, the window for local layers; its plain version
here).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.models import attention as tA
from repro_torch.models.convert import model_from_jax, params_from_jax
from repro_torch.models.transformer import Transformer

from _torch_parity import assert_close

DENSE = ("llama3.2-1b", "qwen2-1.5b", "qwen3-8b", "qwen1.5-110b",
         "qwen2-vl-72b")
TOL = dict(rtol=1e-5, atol=1e-5)


def _tol(arch, want):
    """1e-5 where the dense tests hold it, else 1e-4 of max |logits|."""
    if arch in DENSE:
        return TOL
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0, replace=()):
    """(reference cfg, params, their numpy copy, port cfg), one reference
    init per architecture and replacement."""
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), **dict(replace))
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              **dict(replace))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, jax.tree.map(np.asarray, params), cfg


def _pair(arch, seed=0, **replace):
    """(reference cfg, reference params, port cfg, port model on the CPU)."""
    jcfg, params, pnp, cfg = _reference(arch, seed,
                                        tuple(sorted(replace.items())))
    return jcfg, params, cfg, model_from_jax(cfg, pnp, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _frames(cfg, B):
    """Random encoder frames for an encoder-decoder, else None."""
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(7).normal(
        size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg, last_only):
    return jax.jit(lambda p, t, pos, pat, ef: jT.forward(
        p, jcfg, t, positions=pos, patches=pat, enc_frames=ef,
        last_only=last_only))


def _both(arch, B, S, last_only=False, patches=False, mrope_pos=False,
          **replace):
    jcfg, params, cfg, model = _pair(arch, **replace)
    toks = _tokens(cfg, B, S)
    rng = np.random.default_rng(5)
    pat = pos = None
    if patches:
        pat = rng.normal(size=(B, cfg.vis_patches, cfg.d_model)).astype(
            np.float32)
    if mrope_pos:
        St = S + (cfg.vis_patches if patches else 0)
        pos = rng.integers(0, 4 * St, (B, St, 3)).astype(np.int32)
    ef = _frames(cfg, B)
    opt = lambda a: None if a is None else jnp.asarray(a)
    want, jaux = _jit_forward(jcfg, last_only)(
        params, jnp.asarray(toks), opt(pos), opt(pat), opt(ef))
    opt = lambda a: None if a is None else torch.tensor(a)
    got, aux = model(torch.tensor(toks), positions=opt(pos),
                     patches=opt(pat), enc_frames=opt(ef),
                     last_only=last_only)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert (float(aux) > 0) == (cfg.n_experts > 0)
    return got, np.asarray(want), model, toks


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference_dense_scores(arch):
    got, want, _, toks = _both(arch, 2, 24)
    assert got.shape == (2, 24, 512) and got.dtype == torch.float32
    assert_close(got, want, **_tol(arch, want))


def _f64_logits(arch, toks):
    """Logits of the same weights evaluated in float64 (the port's model
    with ``dtype = param_dtype = float64``), the yardstick of f32 rounding."""
    jcfg, params, cfg, _ = _pair(arch)
    c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    m64 = Transformer(c64, device="cpu")
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    m64.load_state_dict({k: v.double() for k, v in sd.items()})
    h, _ = m64(torch.tensor(toks), return_hidden=True)
    w = m64.embed.unembed if m64.embed.unembed is not None else m64.embed.tok.T
    return (h @ w).detach().numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference_chunked(arch):
    """S = 1536 > 2·512: the reference's query-chunked attention.  At this
    length the two packages' f32 roundings part by up to 1.6e-5, nearly all
    of it the reference's own: against a float64 evaluation of the same
    weights the reference is off by 1.2e-5–1.6e-5 and the port by 1e-6–6e-6.
    So the port is held to the reference at rtol = atol = 3e-5 (the sum of
    the two), to the float64 logits at 1e-5, and to be no farther from
    them than the reference is."""
    got, want, _, toks = _both(arch, 1, 1536)
    assert_close(got, want, rtol=3e-5, atol=3e-5)
    truth = _f64_logits(arch, toks)
    assert_close(got, truth, **TOL)
    assert np.abs(got.detach().numpy() - truth).max() <= np.abs(
        want - truth).max()


def test_local_prefill_matches_reference_chunked_band():
    """recurrentgemma at S = 1536 > 2·512: the reference restricts each
    512-query chunk to its window band (``attention.py:116``), the port
    walks the band's tiles (its plain version here); window 16."""
    got, want, _, _ = _both("recurrentgemma-2b", 1, 1536)
    assert_close(got, want, **_tol("recurrentgemma-2b", want))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_last_only_matches_reference(arch):
    got, want, model, toks = _both(arch, 2, 40, last_only=True)
    assert got.shape == (2, 1, 512)
    assert_close(got, want, **_tol(arch, want))
    ef = _frames(model.cfg, 2)
    full, _ = model(torch.tensor(toks),
                    enc_frames=None if ef is None else torch.tensor(ef))
    assert_close(got[:, 0], full[:, -1], **_tol(arch, want))


@pytest.mark.parametrize("mrope_pos", [False, True])
def test_qwen2_vl_patches_and_mrope(mrope_pos):
    got, want, _, _ = _both("qwen2-vl-72b", 2, 20, patches=True,
                            mrope_pos=mrope_pos)
    assert got.shape == (2, 28, 512)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-8b"])
def test_padded_vocab_unembed(arch):
    """vocab 500 pads to 512 with −1e30 columns (tied: llama; untied:
    qwen3); sliced logits have 500 columns, ``sliced=False`` keeps 512."""
    got, want, model, _ = _both(arch, 2, 24, vocab=500)
    assert got.shape == (2, 24, 500)
    assert_close(got, want, **TOL)
    jcfg, params, cfg, model = _pair(arch, vocab=500)
    x = np.random.default_rng(2).normal(size=(2, 3, 64)).astype(np.float32)
    jw = jL.unembed(params["embed"], jnp.asarray(x), jcfg, sliced=False)
    tw = model.embed.logits(torch.tensor(x), sliced=False)
    assert tw.shape == (2, 3, 512)
    assert_close(tw, jw, **TOL)
    assert bool((tw[..., 500:] == -1e30).all())


#: what each kind's sub-layers hand the flash wrapper: (query rows, key
#: rows, KV heads, causal, window) with S queries and F encoder frames
def _expected_calls(cfg, B, S):
    F = cfg.enc_frames
    per = {"attn": [(S, S, cfg.n_kv_heads, True, 0)],
           "moe": [(S, S, cfg.n_kv_heads, True, 0)],
           "attn_local": [(S, S, cfg.n_kv_heads, True, cfg.window)],
           "rec": [], "ssd": []}
    enc = ([(F, F, cfg.n_kv_heads, False, 0)] * cfg.n_enc_layers
           if cfg.enc_dec else [])
    cross = [(S, F, cfg.n_heads, False, 0)] if cfg.enc_dec else []
    calls = enc + [c for kind in cfg.pattern_layers
                   for c in per[kind] + cross]
    return [((B, s, cfg.n_heads, cfg.hd), (B, t, k, cfg.hd), c, w)
            for s, t, k, c, w in calls]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_on_kernel_route_matches_reference(arch, monkeypatch):
    """The forward's attention core is one flash-wrapper call per attention
    sub-layer on q (B, S, H, hd) and k (B, T, K, hd) as projected — causal,
    windowed for local layers, bidirectional in the encoder and unmasked
    over the encoder's frames for cross attention (K = H): the card's
    route, its plain version here."""
    calls = []

    def spy(q, k, v, *, causal, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return flash_attention_gqa(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tA, "flash_attention_gqa", spy)
    got, want, model, _ = _both(arch, 2, 24)
    assert_close(got, want, **_tol(arch, want))
    assert calls == _expected_calls(model.cfg, 2, 24)


def _ring_positions(S, cap):
    """The absolute position each ring slot holds after S steps."""
    return [max(t for t in range(S) if t % cap == s) for s in range(cap)]


def _decode_both(arch, B, S, **replace):
    """(port per-step logits (B, S, V), port forward logits, model, state),
    every step held to the reference's step."""
    jcfg, params, cfg, model = _pair(arch, **replace)
    toks = _tokens(cfg, B, S, seed=3)
    ef = _frames(cfg, B)
    jstate = jT.init_decode_state(params, jcfg, B, S, enc_frames=None
                                  if ef is None else jnp.asarray(ef))
    jstep = jax.jit(lambda p, s, t, pos: jT.decode_step(p, jcfg, s, t, pos))
    state = model.init_decode_state(B, S, enc_frames=None if ef is None
                                    else torch.tensor(ef))
    outs = []
    for t in range(S):
        jl, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                           jnp.array(t))
        lg, state = model.decode_step(state, torch.tensor(toks[:, t:t + 1]),
                                      t)
        assert lg.shape == (B, 1, 512)
        assert_close(lg, jl, **_tol(arch, np.asarray(jl)))
        outs.append(lg[:, 0])
    full, _ = model(torch.tensor(toks), enc_frames=None if ef is None
                    else torch.tensor(ef))
    return torch.stack(outs, 1), full, model, state


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_reference_and_forward(arch):
    S = 20
    dec, full, model, state = _decode_both(arch, 2, S)
    assert_close(dec, full, rtol=0, atol=5e-4)
    cfg = model.cfg
    for kind, c in zip(cfg.pattern_layers, state["layers"]):
        if kind in ("rec", "ssd"):
            assert set(c) >= {"h", "conv"}
            continue
        cap = min(S, cfg.window) if kind == "attn_local" else S
        assert c["pos"].tolist() == _ring_positions(S, cap)
        if cfg.enc_dec:
            assert c["cross_k"].shape == (2, cfg.enc_frames, cfg.n_heads,
                                          cfg.hd)


def test_local_attention_ring_cache_beyond_window():
    """The reference test of the same name: recurrentgemma decoding 40
    tokens past a 16-token window — the ring (capacity 16) must give the
    full forward's logits with the local mask, and each step the
    reference's."""
    dec, full, model, state = _decode_both("recurrentgemma-2b", 1, 40)
    assert model.cfg.window == 16
    caps = [c["k"].shape[1] for c in state["layers"] if "k" in c]
    assert caps and all(c == 16 for c in caps)
    assert_close(dec, full, rtol=0, atol=5e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    actual = sum(p.numel() for p in model.parameters())
    assert actual == sum(x.size for x in jax.tree.leaves(params))
    assert cfg.param_count() == jcfg.param_count()
    assert abs(actual - cfg.param_count()) / actual < 0.35
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_seeded_init_scales():
    """The port's own init: 0.02 for the token table, 1/√fan_in for the
    projections, ones for the norms; the same seed gives the same
    weights."""
    cfg = smoke_variant(get_config("qwen3-8b"))
    a = Transformer(cfg, seed=3, device="cpu")
    b = Transformer(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert abs(float(a.embed.tok.std()) - 0.02) < 0.002
    wq = a.layers[0].attn.wq
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    assert torch.equal(a.layers[1].attn.q_norm.scale, torch.ones(16))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in a.parameters())


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(smoke_variant(get_config("llama3.2-1b")))


def test_registry_matches_reference():
    from repro.configs import ARCH_IDS as JIDS
    assert ARCH_IDS == JIDS
    for a in ARCH_IDS:
        assert dataclasses.asdict(get_config(a)) == \
            dataclasses.asdict(jget_config(a))
