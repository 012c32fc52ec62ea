"""PyTorch port vs the JAX reference: flash attention.

The port's ``flash_attention`` on CPU tensors (its plain version,
``kernels.ref.flash_attention_ref``) against the reference's Pallas kernel
in interpret mode and its ``flash_attention_ref``, on the reference test's
sweep (bh 1–4, S = 64·(1–4), d ∈ {32, 64}, causal on and off) and its
uneven T ≠ S shape, at the reference test's rtol = atol = 2e-5 (f32).  A
ragged S = 100 (not a block multiple: the reference kernel refuses it) is
held against the reference's ``flash_attention_ref`` only.  The model's
kernel route (q, k, v to (B·H, S, hd) with the KV heads expanded) is held
against the reference model's GQA score/softmax/PV core.  On a CUDA card,
the hand-written kernel against its plain version (skipped here).
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

from _torch_parity import assert_close, cuda_device  # noqa: F401

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,S,T", [
    (torch.float32, 64, True, 256, 256), (torch.float32, 64, False, 128, 256),
    (torch.bfloat16, 128, True, 1000, 1000), (torch.float32, 16, True, 77, 77),
    (torch.bfloat16, 32, False, 65, 130)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, d, causal, S,
                                            T):
    from repro_torch import kernels
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(3, n, d)), dtype=dtype,
                            device=cuda_device) for n in (S, T, T))
    kernels.reset_launch_counts()
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert kernels.launch_counts()[
        "flash_attention" if bf16 else "flash_attention_f32"] == 1
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
    diff = (out.float() - want).abs()
    rtol, atol = BF16_TOL if bf16 else (2e-5, 2e-5)
    assert bool((diff <= rtol * want.abs() + atol).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_gqa_kernel_matches_plain_on_card(cuda_device, dtype, K):
    """The kernel reads strided (B, S, H, d) / (B, T, K, d) views in place:
    q sliced out of a fused projection, S ≠ T ragged."""
    B, S, T, H, d = 2, 300, 333, 8, 64
    rng = np.random.default_rng(K)
    qkv = torch.tensor(rng.normal(size=(B, S, H + 2 * K, d)), dtype=dtype,
                       device=cuda_device)
    q = qkv[:, :, :H]
    k, v = (torch.tensor(rng.normal(size=(B, T, K, d)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    out = flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()

    def heads(t):
        t = t.float().repeat_interleave(H // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

    want = tref.flash_attention_ref(heads(q), heads(k), heads(v),
                                    causal=True).reshape(B, H, S, d)
    want = want.transpose(1, 2)
    rtol, atol = BF16_TOL if dtype == torch.bfloat16 else (2e-5, 2e-5)
    assert bool(((out.float() - want).abs() <= rtol * want.abs() + atol).all())
