"""PyTorch port vs the JAX reference: LM serving.

The same numpy prompts go through the reference's ``make_serve_step`` loop
and the port's (``launch.serve.greedy_decode``: prompts teacher-forced
through ``decode_step``, then greedy generation) on carried weights; the
token sequences must be identical.  ``prefill`` is the reference dry-run's
prefill function (``forward(last_only=True)``).  The port's CLI runs on the
CPU with ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.launch.serve import make_serve_step as jmake_serve_step
from repro.models import transformer as jT
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models.convert import model_from_jax

from _torch_parity import assert_close


def _pair(arch, seed=0):
    jcfg = jsmoke(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    params = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, cfg, model_from_jax(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


def _reference_greedy(jcfg, params, prompts, gen_len, enc_frames=None):
    """The reference CLI's loop (``repro/launch/serve.py::main``), with
    the position as a default-width integer: under the suite's x64 mode the
    reference's ``dynamic_update_slice`` refuses the CLI's int32 position
    beside its int64 zeros."""
    B, P = prompts.shape
    total = P + gen_len
    state = jT.init_decode_state(params, jcfg, B, total,
                                 enc_frames=enc_frames)
    step = jax.jit(jmake_serve_step(jcfg))
    prompts = jnp.asarray(prompts, jnp.int32)
    tok = prompts[:, :1]
    out = [tok]
    for t in range(total - 1):
        nxt, state = step(params, state, tok, jnp.array(t))
        tok = prompts[:, t + 1:t + 2] if t + 1 < P else nxt
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-1.5b", "qwen3-8b",
                                  "granite-moe-1b-a400m", "mamba2-780m",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_greedy_serving_matches_reference(arch):
    """whisper attends to the CLI's zero encoder frames."""
    jcfg, params, cfg, model = _pair(arch)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab, (3, 7))
    ef = serve.zero_frames(model, 3)
    want = _reference_greedy(jcfg, params, prompts, 9, None if ef is None
                             else jnp.zeros(ef.shape, jnp.float32))
    got, seconds = serve.greedy_decode(model, torch.tensor(prompts), 9,
                                       enc_frames=ef)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    assert seconds > 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :7].numpy(), prompts)


def test_serve_step_is_greedy_argmax():
    _, _, cfg, model = _pair("llama3.2-1b")
    state = model.init_decode_state(2, 4)
    tok = torch.tensor([[3], [9]])
    step = serve.make_serve_step(model)
    nxt, state = step(state, tok, 0)
    lg, _ = model.decode_step(model.init_decode_state(2, 4), tok, 0)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], lg[:, -1].argmax(-1).to(torch.int32))


def test_prefill_matches_reference_prefill():
    jcfg, params, cfg, model = _pair("qwen2-vl-72b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 30))
    pat = rng.normal(size=(2, cfg.vis_patches, cfg.d_model)).astype(
        np.float32)
    want, _ = jT.forward(params, jcfg, jnp.asarray(toks),
                         patches=jnp.asarray(pat), last_only=True)
    got = serve.prefill(model, torch.tensor(toks), patches=torch.tensor(pat))
    assert got.shape == (2, 1, cfg.vocab)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cli_runs_on_the_cpu(capsys):
    seq = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--gen-len", "6", "--seed", "3"])
    assert seq.shape == (2, 11) and seq.dtype == torch.int32
    assert int(seq.min()) >= 0 and int(seq.max()) < 512
    out = capsys.readouterr().out
    assert "arch=mamba2-780m batch=2 steps=10 device=cpu" in out


@pytest.mark.parametrize("arch", (None,) + ARCH_IDS)
def test_cli_defaults(arch, capsys):
    """The CLI's defaults (batch 4, prompt 32, 32 generated) for every
    architecture; without ``--arch`` the reference CLI's mamba2-780m."""
    seq = serve.main(["--smoke", "--device", "cpu"]
                     + ([] if arch is None else ["--arch", arch]))
    assert seq.shape == (4, 64)
    assert f"arch={arch or 'mamba2-780m'} batch=4 steps=63" in \
        capsys.readouterr().out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_smoke_config_is_the_reference_smoke_config():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(smoke_variant(get_config(arch))) == \
            dataclasses.asdict(jsmoke(jget_config(arch)))
