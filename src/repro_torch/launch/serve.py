"""Serving: prefill, the greedy one-token serve step and a batched greedy
decoding loop with its CLI.

The port of the reference's ``repro/launch/serve.py`` (and of the prefill
function its dry-run lowers).  The CLI runs batched greedy decoding of any
registry architecture (default mamba2-780m, as the reference's) on the
card, or on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Prompts are teacher-forced through ``decode_step`` one token at a time and
the generated tokens follow, as in the reference.  The weights are the
port's seeded init (``--seed``); prompts come from a ``torch.Generator``
seeded with 1, so they differ from the reference's ``jax.random`` prompts.
An encoder-decoder (whisper) takes zero frame embeddings (B, enc_frames,
d_model), as the reference's CLI builds them.  Serving records no
gradients: ``prefill`` and ``greedy_decode`` run under ``torch.no_grad()``.

:func:`jit_serve_step` is the sharded serve step: parameters, decode state
and token as ``DTensor``\\ s placed by the logical-axis rules
(``models.transformer.param_axes`` / ``cache_axes``, ``launch.shardings``)
over a ``DeviceMesh``.
"""
from __future__ import annotations

import argparse
import time

import torch

from torch.distributed.tensor.experimental import implicit_replication

from ..configs import get_config, smoke_variant
from ..core._device import resolve_device
from ..models.layers import adtype
from ..models.transformer import Transformer, cache_axes, param_axes
from . import shardings as sh
from .train import _place, _tree_place, bind_params


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, patches=None,
            enc_frames=None) -> torch.Tensor:
    """Logits (B, 1, V) f32 of the last prompt position."""
    logits, _ = model(tokens, patches=patches, enc_frames=enc_frames,
                      last_only=True)
    return logits


def zero_frames(model: Transformer, batch: int):
    """The CLI's encoder input: zeros (B, enc_frames, d_model) in the
    activation dtype, or None for a decoder-only model."""
    cfg = model.cfg
    if not cfg.enc_dec:
        return None
    return torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                       dtype=adtype(cfg), device=model.device)


def make_serve_step(model: Transformer):
    """``serve_step(state, token, pos) -> (next token (B, 1) int32, state)``:
    one decode step and the greedy argmax of its logits."""
    def serve_step(state, token, pos):
        logits, state = model.decode_step(state, token, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], state

    return serve_step


def jit_serve_step(model_or_cfg, rules: sh.Rules, params_shapes: dict,
                   decode_specs: dict):
    """(step, (parameter placements, state placements)) for the model (or
    config) ``model_or_cfg`` under ``rules``: ``step(params, state, token,
    pos) -> (next token (B, 1) int32, state)``, the greedy serve step on
    parameters placed by :func:`~repro_torch.models.transformer.param_axes`,
    a decode state by :func:`~repro_torch.models.transformer.cache_axes`
    and a token by ``("batch", None)``; the state is updated in place.
    Whole tensors handed in are cut into the rank's shards with no
    communication (:func:`distribute_params` / :func:`distribute_decode_state`
    place them once); the step binds ``params`` into a storage-free
    skeleton."""
    cfg = model_or_cfg.cfg if isinstance(model_or_cfg, Transformer) \
        else model_or_cfg
    p_pl = sh.make_specs(rules, param_axes(params_shapes), params_shapes)
    c_pl = sh.make_specs(rules, cache_axes(decode_specs["state"]),
                         decode_specs["state"])
    tok_pl = rules.placements(("batch", None), decode_specs["token"].shape)
    mesh = rules.mesh
    model = Transformer(cfg, device="meta")

    @torch.no_grad()
    def step(params, state, token, pos):
        bind_params(model, sh.gather_params(
            _tree_place(params, mesh, p_pl), rules))
        token = _place(token, mesh, tok_pl)
        with sh.use_rules(rules), implicit_replication():
            logits, state = model.decode_step(state, token, pos)
            # the vocabulary whole before the argmax (one token a row)
            nxt = torch.argmax(sh.unshard(logits[:, -1], -1), dim=-1).to(
                torch.int32)
        return _place(nxt[:, None], mesh, tok_pl), state

    return step, (p_pl, c_pl)


def jit_prefill(model_or_cfg, rules: sh.Rules, params_shapes: dict):
    """(prefill, parameter placements): ``prefill(params, tokens,
    patches=None, enc_frames=None) -> logits`` (B, 1, V) of the last
    position, :func:`prefill` on parameters placed by ``param_axes`` and
    inputs placed by ``train.BATCH_AXES`` under ``rules`` (whole tensors
    are cut into the rank's shards with no communication)."""
    from .train import BATCH_AXES
    cfg = model_or_cfg.cfg if isinstance(model_or_cfg, Transformer) \
        else model_or_cfg
    p_pl = sh.make_specs(rules, param_axes(params_shapes), params_shapes)
    mesh = rules.mesh
    model = Transformer(cfg, device="meta")

    @torch.no_grad()
    def run(params, tokens, patches=None, enc_frames=None):
        bind_params(model, sh.gather_params(
            _tree_place(params, mesh, p_pl), rules))
        inputs = {k: _place(v, mesh, rules.placements(BATCH_AXES[k], v.shape))
                  for k, v in (("tokens", tokens), ("patches", patches),
                               ("enc_frames", enc_frames)) if v is not None}
        with sh.use_rules(rules), implicit_replication():
            logits, _ = model(inputs["tokens"], patches=inputs.get("patches"),
                              enc_frames=inputs.get("enc_frames"),
                              last_only=True)
        return logits

    return run, p_pl


def distribute_params(model: Transformer, rules: sh.Rules) -> dict:
    """``model``'s parameters as ``DTensor``\\ s placed by ``param_axes``."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return _tree_place(params, rules.mesh, sh.make_specs(
        rules, param_axes(params), params))


def distribute_decode_state(state: dict, rules: sh.Rules) -> dict:
    """A decode state (``init_decode_state``) as ``DTensor``\\ s placed by
    ``cache_axes``."""
    return _tree_place(state, rules.mesh, sh.make_specs(
        rules, cache_axes(state), state))


@torch.no_grad()
def greedy_decode(model: Transformer, prompts: torch.Tensor, gen_len: int,
                  enc_frames=None):
    """Teacher-force ``prompts`` (B, P) through the serve step, then generate
    ``gen_len`` tokens (an encoder-decoder attends to ``enc_frames``,
    encoded once when the state is set up).  Returns (tokens (B, P +
    gen_len) int32, seconds of the P + gen_len − 1 steps, synchronised)."""
    B, P = prompts.shape
    total = P + gen_len
    state = model.init_decode_state(B, total, enc_frames=enc_frames)
    step = make_serve_step(model)
    prompts = prompts.to(torch.int32)
    tok = prompts[:, :1]
    out = [tok]
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    for t in range(total - 1):
        nxt, state = step(state, tok, t)
        tok = prompts[:, t + 1:t + 2] if t + 1 < P else nxt
        out.append(tok)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return torch.cat(out, dim=1), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    model = Transformer(cfg, seed=args.seed, device=dev)
    B = args.batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                            generator=gen, device=dev)
    seq, dt = greedy_decode(model, prompts, args.gen_len,
                            enc_frames=zero_frames(model, B))
    steps = args.prompt_len + args.gen_len - 1
    print(f"arch={cfg.name} batch={B} steps={steps} device={dev} "
          f"{dt * 1e3 / steps:.1f} ms/token")
    print("sample:", seq[0, :24].tolist())
    return seq


if __name__ == "__main__":
    main()
