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
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, smoke_variant
from ..core._device import resolve_device
from ..models.layers import adtype
from ..models.transformer import Transformer


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
