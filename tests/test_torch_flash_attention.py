"""PyTorch port vs the JAX reference: flash attention.

The port's ``flash_attention`` on CPU tensors (its plain version,
``kernels.ref.flash_attention_ref``) against the reference's Pallas kernel
in interpret mode and its ``flash_attention_ref``, on the reference test's
sweep (bh 1–4, S = 64·(1–4), d ∈ {32, 64}, causal on and off) and its
uneven T ≠ S shape, at the reference test's rtol = atol = 2e-5 (f32).  A
ragged S = 100 (not a block multiple: the reference kernel refuses it) is
held against the reference's ``flash_attention_ref`` only.  The model's
kernel route (q, k, v to (B·H, S, hd) with the KV heads expanded) is held
against the reference model's GQA score/softmax/PV core.  The
hand-written kernel is held to its plain version on a card by
``test_torch_on_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention import flash_attention_ref as jfa_ref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_gqa)

from _torch_parity import assert_close

TOL = dict(rtol=2e-5, atol=2e-5)
#: the card checks' bf16 rule, elementwise |o − plain| <= rtol·|plain| + atol:
#: 4 half-ulps of the output's rounding and an atol for outputs near 0
BF16_TOL = (8e-3, 1e-3)


def _qkv(bh, S, T, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(bh, n, d)).astype(dtype)
                 for n in (S, T, T))


def _port(q, k, v, causal):
    return flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal=causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s_blocks", [1, 2, 3, 4])
def test_flash_attention_sweep(s_blocks, d, causal):
    seed = 10 * s_blocks + d // 32 + 5 * causal
    bh = 1 + seed % 4
    S = 64 * s_blocks
    q, k, v = _qkv(bh, S, S, d, seed)
    out = _port(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert_close(out, jfa(jq, jk, jv, causal=causal, bq=64, bk=64), **TOL)
    assert_close(out, jfa_ref(jq, jk, jv, causal=causal), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_uneven_blocks(causal):
    """KV longer than queries (2, 128 | 256, 64); causal is top-left."""
    q, k, v = _qkv(2, 128, 256, 64, 0)
    out = _port(q, k, v, causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert_close(out, jfa(jq, jk, jv, causal=causal, bq=64, bk=128), **TOL)
    assert_close(out, jfa_ref(jq, jk, jv, causal=causal), **TOL)


@pytest.mark.parametrize("S,T,causal", [(100, 100, True), (100, 100, False),
                                        (100, 37, False), (37, 100, True)])
def test_flash_attention_ragged(S, T, causal):
    q, k, v = _qkv(3, S, T, 64, 7)
    out = _port(q, k, v, causal)
    want = jfa_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    assert out.shape == (3, S, 64)
    assert_close(out, want, **TOL)


def test_flash_attention_bf16_plain_version():
    """bf16 in, f32 inside, bf16 out: equal to the reference's oracle to
    one bf16 rounding of the output (2^-8 relative)."""
    q, k, v = _qkv(2, 96, 96, 64, 3)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = np.asarray(jfa_ref(jq, jk, jv, causal=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8)


@pytest.mark.parametrize("fault", [None, "drop last kv tile", "mask j < i"])
def test_bf16_rule_rejects_a_wrong_kernel(fault):
    """The card checks' bf16 rule at a long causal row (S 2048): a correct
    kernel's output (the plain one rounded to bf16) passes, while a kernel
    that skips the last 64-key tile or masks key i from query i fails."""
    rng = np.random.default_rng(11)
    S, d = 2048, 64
    q, k, v = (torch.tensor(rng.normal(size=(2, S, d)), dtype=torch.float32)
               .bfloat16().float() for _ in range(3))
    want = tref.flash_attention_ref(q, k, v, causal=True)
    if fault is None:
        got = want.clone()
    elif fault == "drop last kv tile":
        got = want.clone()
        got[:, S - 64:] = tref.flash_attention_ref(
            q[:, S - 64:], k[:, :S - 64], v[:, :S - 64], causal=False)
    else:
        got = tref.flash_attention_ref(q[:, 1:], k, v, causal=True)
        got = torch.cat([want[:, :1], got], dim=1)
    rtol, atol = BF16_TOL
    ok = bool(((got.bfloat16().float() - want).abs()
               <= rtol * want.abs() + atol).all())
    assert ok == (fault is None)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("K", [4, 2, 1])
def test_kernel_route_matches_model_attention(K, causal):
    """The model's kernel route — one flash call on (B, S, H, hd) q and
    (B, S, K, hd) k, v, KV head h // (H/K) — equals the reference model's
    GQA score/softmax/PV core."""
    from repro.configs.base import ModelConfig
    from repro.models import attention as A
    from repro_torch.models import attention as tA

    B, S, H, hd = 2, 128, 4, 16
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=H, n_kv_heads=K, d_ff=0, vocab=16, head_dim=hd,
                      dtype="float32", param_dtype="float32", remat="none")
    rng = np.random.default_rng(K)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    s = A._gqa_scores(jnp.asarray(q), jnp.asarray(k), cfg).astype(jnp.float32)
    if causal:
        mask = jnp.arange(S)[None, :] <= jnp.arange(S)[:, None]
        s = jnp.where(mask[None, None], s, A.NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    want = jnp.einsum("bhst,bthd->bshd", p,
                      A._expand_kv(jnp.asarray(v), H))
    got = tA.flash_attention_gqa(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), causal=causal)
    assert got.shape == (B, S, H, hd)
    assert_close(got, want, **TOL)


def test_flash_attention_has_no_detour_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card raises: the plain
    version runs only for CPU tensors."""
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="tensors on meta"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 100])
def test_p_rounded_plain_matches_reference_model_formula(S, causal):
    """``round_p=True`` on bf16 inputs equals the reference model's dense
    attention formula (f32 scores, softmax, probabilities rounded to bf16,
    p·v on the bf16 values) to one bf16 rounding of the output."""
    from repro.configs.base import ModelConfig
    from repro.models import attention as A

    B, H, hd = 2, 4, 32
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=H, n_kv_heads=H, d_ff=0, vocab=16, head_dim=hd,
                      dtype="bfloat16", param_dtype="float32", remat="none")
    rng = np.random.default_rng(S + causal)
    q, k, v = (torch.tensor(rng.normal(size=(B, S, H, hd)),
                            dtype=torch.bfloat16) for _ in range(3))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    s = A._gqa_scores(jq.astype(jnp.float32), jk.astype(jnp.float32), cfg)
    if causal:
        mask = jnp.arange(S)[None, :] <= jnp.arange(S)[:, None]
        s = jnp.where(mask[None, None], s, A.NEG_INF)
    p = jax.nn.softmax(s, axis=-1).astype(jnp.bfloat16)
    want = jnp.einsum("bhst,bthd->bshd", p, jv).astype(jnp.float32)

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, S, hd)

    got = tref.flash_attention_ref(heads(q), heads(k), heads(v),
                                   causal=causal, round_p=True)
    assert got.dtype == torch.bfloat16
    got = got.reshape(B, H, S, hd).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_gqa_form_matches_expanded_form(K, causal):
    """flash_attention_gqa on q (B, S, H, d), k, v (B, T, K, d) equals the
    (B·H, S, d) form on the KV heads expanded (query head h on KV head
    h // (H/K)), S ≠ T."""
    B, S, T, H, d = 2, 72, 90, 4, 32
    rng = np.random.default_rng(K + 3 * causal)
    q = torch.tensor(rng.normal(size=(B, S, H, d)), dtype=torch.float32)
    k, v = (torch.tensor(rng.normal(size=(B, T, K, d)), dtype=torch.float32)
            for _ in range(2))
    got = flash_attention_gqa(q, k, v, causal=causal)
    assert got.shape == (B, S, H, d) and got.is_contiguous()

    def heads(t):
        t = t.repeat_interleave(H // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

    want = flash_attention(heads(q), heads(k), heads(v), causal=causal)
    assert_close(got, want.reshape(B, H, S, d).transpose(1, 2), rtol=0,
                 atol=0)


def test_f32_tile_rule():
    """The f32 kernel's block: query heads of one KV head that share its
    K/V tiles (the largest of 8, 4, 2, 1 dividing H/K), 128 rows where that
    grid fills the 132 SMs twice over, else 32."""
    from repro_torch.kernels.flash_attention import f32_tile
    sms = 132                                          # an H100 SXM
    assert f32_tile(2, 32, 8, 128, sms) == (32, 4)     # the f32 check's call
    assert f32_tile(4, 32, 8, 4096, sms) == (128, 4)   # the prefill shape
    assert f32_tile(64, 1, 1, 2048, sms) == (128, 1)   # (BH, S, d) form
    assert f32_tile(2, 1, 1, 128, sms) == (32, 1)
    assert f32_tile(2, 1, 1, 128, 1) == (128, 1)       # a one-SM card
    assert [f32_tile(1, G, 1, 64, sms)[1]
            for G in (1, 2, 3, 4, 6, 8, 12, 16)] == [1, 2, 1, 4, 2, 8, 4, 8]
    for B, H, K, S in [(1, 8, 8, 1), (3, 6, 3, 64), (8, 16, 2, 257),
                       (90, 2, 1, 140), (1, 32, 8, 100000)]:
        rows, heads = f32_tile(B, H, K, S, sms)
        assert (H // K) % heads == 0 and rows % heads == 0
        big = B * K * (H // K // heads) * -(-S // (128 // heads))
        assert rows == (128 if big >= 2 * sms else 32)
