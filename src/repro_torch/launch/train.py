"""The training step and the fault-tolerant training CLI.

The port of the reference's ``repro/launch/train.py`` on one device.
``make_train_step`` builds ``step(state, batch) -> (state, metrics)``:
the forward on the state's parameters (a storage-free skeleton of the
model, its parameters bound to the state's tensors each step), the loss
``loss + 0.01·aux`` with the cross-entropy over batch chunks, one
``torch.autograd.grad`` and one AdamW update — out of place, so the state
given stays as it was.  The state is ``{"params": {name: tensor}, "opt":
{"m", "v", "step"}}``, the names those of ``named_parameters()``.  The CLI
trains a reduced or full config with checkpoint/restart through the FT
driver, on the card or with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 12 --batch 4 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``state_axes``, ``make_shardings`` and ``jit_train_step`` (the reference's
GSPMD sharded step) have no one-card counterpart here.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
from torch.utils import checkpoint as _ckpt

from ..configs import get_config, smoke_variant
from ..configs.base import ModelConfig
from ..core._device import resolve_device
from ..models.layers import adtype
from ..models.transformer import Transformer
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state


def _ce_terms(embed, x, labels):
    """(−Σ log p, Σ mask) for one slice of hidden states ``x`` and labels
    (< 0: masked): the logits live only in here, in the padded layout
    (``Embed.logits(sliced=False)``, vocab padded to a multiple of 256)."""
    logits = embed.logits(x, sliced=False)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    lse = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lse, -1, safe[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def chunked_ce(embed, x, labels, num_chunks: int):
    """Cross-entropy over ``num_chunks`` batch chunks, each under
    ``torch.utils.checkpoint``: the (B, S, V) f32 logits never exist whole —
    the extra memory is one (B/num_chunks, S, V) block, in the forward and
    again when the backward recomputes it."""
    B = x.shape[0]
    if num_chunks <= 1 or B % num_chunks:
        return _ce_terms(embed, x, labels)
    c = B // num_chunks
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        n, m = _ckpt.checkpoint(_ce_terms, embed, x[i * c:(i + 1) * c],
                                labels[i * c:(i + 1) * c],
                                use_reentrant=False)
        nll, cnt = nll + n, cnt + m
    return nll, cnt


def loss_fn(model: Transformer, batch: dict, num_ce_chunks: int = 1):
    """(total, metrics): total = mean token NLL + 0.01 · MoE aux;
    metrics ``loss``, ``moe_aux``, ``tokens``.  ``batch``: ``tokens``,
    ``labels`` and, where the model takes them, ``patches`` /
    ``enc_frames``."""
    hidden, aux = model(batch["tokens"], patches=batch.get("patches"),
                        enc_frames=batch.get("enc_frames"),
                        return_hidden=True)
    nll, cnt = chunked_ce(model.embed, hidden, batch["labels"],
                          num_ce_chunks)
    loss = nll / torch.clamp(cnt, min=1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "moe_aux": aux, "tokens": cnt}


def bind_params(model: Transformer, params: dict) -> None:
    """Make ``params`` (name → tensor) the model's parameters, in place of
    whatever it holds (the skeleton's storage-free ones)."""
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = t


def init_state(model: Transformer) -> dict:
    """The training state of ``model``'s parameters: ``{"params", "opt"}``
    (the parameters detached; f32 moments at zero, step 0)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": params, "opt": init_opt_state(params)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_ce_chunks: int = 1):
    """``step(state, batch) -> (state, metrics)``: loss and gradient of
    :func:`loss_fn`, then :func:`~repro_torch.optim.adamw.adamw_update`;
    metrics ``loss``, ``moe_aux``, ``tokens``, ``grad_norm``, ``lr`` and
    ``total_loss`` (0-dim tensors on the state's device).  The batch moves
    to the parameters' device."""
    model = Transformer(cfg, device="meta")

    def step(state, batch):
        params = state["params"]
        dev = next(iter(params.values())).device
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        bind_params(model, leaves)
        batch = {k: v.to(dev) for k, v in batch.items()}
        total, metrics = loss_fn(model, batch, num_ce_chunks)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        new_params, opt, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                    state["opt"])
        bind_params(model, new_params)       # hold no stale tensor
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, total_loss=total.detach())
        return {"params": new_params, "opt": opt}, metrics

    return step


# ---------------------------------------------------------------------------
# CLI: training with fault tolerance
# ---------------------------------------------------------------------------

def make_batch_fn(cfg: ModelConfig, seed: int, batch: int, seq: int):
    """``make_batch(step)``: the synthetic batch of ``step`` (seq tokens
    and their next tokens), with zero patches (their labels masked) for a
    VLM and zero frames for an encoder-decoder, as the reference's CLI."""
    from ..data.tokens import synthetic_batch

    def make_batch(s):
        b = synthetic_batch(seed, s, batch, seq + 1, cfg.vocab)
        if cfg.vis_patches:
            P = cfg.vis_patches
            b = {"tokens": b["tokens"],
                 "patches": torch.zeros((batch, P, cfg.d_model),
                                        dtype=adtype(cfg)),
                 "labels": torch.cat([torch.full((batch, P), -1,
                                                 dtype=b["labels"].dtype),
                                      b["labels"]], 1)}
        elif cfg.enc_dec:
            b = dict(b, enc_frames=torch.zeros(
                (batch, cfg.enc_frames, cfg.d_model), dtype=adtype(cfg)))
        return b

    return make_batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ce-chunks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..ft.driver import FTConfig, TrainLoop

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    model = Transformer(cfg, seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M steps={args.steps} "
          f"batch={args.batch} seq={args.seq} device={dev}")
    state = init_state(model)
    del model
    step = make_train_step(cfg, opt_cfg, args.ce_chunks)
    loop = TrainLoop(FTConfig(ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every),
                     step, make_batch_fn(cfg, args.seed, args.batch,
                                         args.seq), device=dev)
    start = 0
    if args.resume:
        latest = loop.mgr.latest_step()
        if latest is not None:
            state = loop.mgr.restore(latest, state, dev)
            start = latest
            print(f"resumed from step {latest}")
    state, last = loop.run(state, args.steps, start_step=start,
                           fail_at=args.fail_at)
    print(f"finished at step {last}")
    return state


if __name__ == "__main__":
    main()
