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

The sharded step is :func:`jit_train_step`: the same eager step on a state
of ``DTensor``\\ s placed by the logical-axis rules (``launch.shardings``)
over a ``DeviceMesh`` — in this package "jit" means sharded, not compiled.
:func:`distribute_state` shards a one-device state (e.g. from
``models.convert.state_from_jax``) by those placements.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import checkpoint as _ckpt

from ..configs import get_config, smoke_variant
from ..configs.base import ModelConfig
from ..core._device import resolve_device
from ..models.layers import adtype
from ..models.transformer import Transformer, param_axes
from ..optim.adamw import (AdamWConfig, adamw_apply, adamw_update,
                           init_opt_state)
from . import shardings as sh

BATCH_AXES = {
    "tokens": ("batch", None), "labels": ("batch", None),
    "patches": ("batch", None, None), "enc_frames": ("batch", None, None),
}


def _vocab_split(logits) -> bool:
    """Whether ``logits``' vocabulary dimension is split between ranks."""
    if not isinstance(logits, DTensor):
        return False
    last = logits.ndim - 1
    return any(getattr(p, "dim", None) == last and
               logits.device_mesh.size(m) > 1
               for m, p in enumerate(logits.placements))


def _ce_terms(embed, x, labels):
    """(−Σ log p, Σ mask) for one slice of hidden states ``x`` and labels
    (< 0: masked): the logits live only in here, in the padded layout
    (``Embed.logits(sliced=False)``, vocab padded to a multiple of 256).
    With the vocabulary split between ranks, log p is formed without
    gathering it (vocabulary-parallel cross-entropy): the row max and the
    sum of exponentials reduce across ranks, and the label's logit is
    picked by a one-hot mask."""
    logits = embed.logits(x, sliced=False).to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    if _vocab_split(logits):
        # each reduction over the vocabulary made whole at once (as the
        # rows are placed), so no sum is left to ``DTensor`` to place
        mesh, pl = logits.device_mesh, logits.placements
        rows = [p if p == Shard(0) else Replicate() for p in pl]
        whole = lambda t: t.redistribute(mesh, rows)  # noqa: E731
        top = whole(logits.detach().amax(dim=-1, keepdim=True))
        lse = torch.log(whole(torch.exp(logits - top).sum(-1))) + top[..., 0]
        hot = (torch.arange(logits.shape[-1], device=logits.device)
               == safe[..., None]).redistribute(mesh, pl)
        ll = whole((logits * hot).sum(-1)) - lse
    else:
        lse = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(lse, -1, safe[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def chunked_ce(embed, x, labels, num_chunks: int):
    """Cross-entropy over ``num_chunks`` batch chunks, each under
    ``torch.utils.checkpoint``: the (B, S, V) f32 logits never exist whole —
    the extra memory is one (B/num_chunks, S, V) block, in the forward and
    again when the backward recomputes it.  Chunk i takes rows i,
    i + num_chunks, …: with the batch sharded into num_chunks-row blocks
    (:func:`jit_train_step`'s rule), one row of each shard, so no chunk
    moves a row between ranks."""
    B = x.shape[0]
    if num_chunks <= 1 or B % num_chunks:
        return _ce_terms(embed, x, labels)
    c = B // num_chunks
    xs = x.reshape(c, num_chunks, *x.shape[1:])
    ls = labels.reshape(c, num_chunks, *labels.shape[1:])
    nll = cnt = 0.0
    for i in range(num_chunks):
        n, m = _ckpt.checkpoint(_ce_terms, embed, xs[:, i], ls[:, i],
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


def bind_params(model: torch.nn.Module, params: dict) -> None:
    """Make ``params`` (name → tensor) the parameters of ``model`` (or of
    one of its layers, the names relative to it), in place of whatever it
    holds (the skeleton's storage-free ones)."""
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = t


def _layer_units(model: Transformer) -> dict:
    """The model's layers, decoder and encoder, by their parameters' name
    prefix: the units a sharded step gathers its parameters for."""
    units = {f"layers.{i}": m for i, m in enumerate(model.layers)}
    if model.encoder is not None:
        units.update({f"encoder.layers.{i}": m
                      for i, m in enumerate(model.encoder.layers)})
    return units


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
    to the parameters' device.

    Under logical-axis rules (:func:`jit_train_step`), a layer's
    parameters are gathered over the batch axes (FSDP) as the layer's
    forward begins and its shards bound again as it ends; with remat the
    recompute gathers them anew, so a layer's gathered copy lives only
    while that layer runs.  The parameters outside the layers (embedding,
    final norms) are gathered for the whole step."""
    model = Transformer(cfg, device="meta")
    units = _layer_units(model)
    held = {}            # layer → (its parameters' shards, rules), sharded

    def gather_on_entry(layer, args):
        if layer in held:
            shards, rules = held[layer]
            bind_params(layer, sh.gather_params(shards, rules))

    def shards_on_exit(layer, args, out):
        if layer in held:
            bind_params(layer, held[layer][0])

    for layer in units.values():
        layer.register_forward_pre_hook(gather_on_entry)
        layer.register_forward_hook(shards_on_exit)

    def step(state, batch):
        params = state["params"]
        dev = next(iter(params.values())).device
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        rules = sh.current_rules()
        if rules is None:
            bind_params(model, leaves)
        else:
            rest = dict(leaves)
            for prefix, layer in units.items():
                mine = {k[len(prefix) + 1:]: rest.pop(k) for k in list(rest)
                        if k.startswith(prefix + ".")}
                bind_params(layer, mine)
                held[layer] = (mine, rules)
            bind_params(model, sh.gather_params(rest, rules))
        batch = {k: v.to(dev) for k, v in batch.items()}
        try:
            total, metrics = loss_fn(model, batch, num_ce_chunks)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        finally:
            held.clear()
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        update = (_sharded_adamw if isinstance(next(iter(params.values())),
                                               DTensor) else adamw_update)
        new_params, opt, opt_metrics = update(opt_cfg, params, grads,
                                              state["opt"])
        bind_params(model, new_params)       # hold no stale tensor
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, total_loss=total.detach())
        return {"params": new_params, "opt": opt}, metrics

    return step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _sharded_adamw(opt_cfg: AdamWConfig, params: dict, grads: dict,
                   opt: dict):
    """:func:`~repro_torch.optim.adamw.adamw_update` on ``DTensor``\\ s:
    each gradient placed as its parameter (a ``Partial`` one
    reduce-scattered), the global norm from the rank's shards — each
    element counted once: a shard's sum of squares divided by the ranks
    that hold it — in one all-reduce, then the elementwise update on the
    local shards (no sharding propagation a parameter and op)."""
    k0 = next(iter(params))
    mesh = params[k0].device_mesh
    grads = {k: g.redistribute(mesh, params[k].placements)
             if tuple(g.placements) != tuple(params[k].placements) else g
             for k, g in grads.items()}
    sumsq = 0
    for g in grads.values():
        copies = 1
        for m, p in enumerate(g.placements):
            if not p.is_shard():
                copies *= mesh.size(m)
        sumsq = sumsq + torch.sum(torch.square(
            g.to_local().to(torch.float32))) / copies
    sumsq = DTensor.from_local(sumsq, mesh, [Partial()] * mesh.ndim,
                               run_check=False).full_tensor()
    local = lambda tree: {k: t.to_local() for k, t in tree.items()}  # noqa
    new_p, new_opt, metrics = adamw_apply(
        opt_cfg, local(params), local(grads),
        {"m": local(opt["m"]), "v": local(opt["v"]),
         "step": opt["step"].to_local()}, torch.sqrt(sumsq))

    def wrap(tree, like):
        return {k: DTensor.from_local(t, mesh, like[k].placements,
                                      run_check=False, shape=like[k].shape,
                                      stride=like[k].stride())
                for k, t in tree.items()}

    return (wrap(new_p, params),
            {"m": wrap(new_opt["m"], opt["m"]),
             "v": wrap(new_opt["v"], opt["v"]),
             "step": DTensor.from_local(new_opt["step"], mesh,
                                        opt["step"].placements,
                                        run_check=False)}, metrics)


def state_axes(params_shapes: dict) -> dict:
    """Logical axes of the train state: the moments as their parameters,
    the step count replicated."""
    paxes = param_axes(params_shapes)
    return {"params": paxes, "opt": {"m": paxes, "v": paxes, "step": ()}}


#: placements parallel to a tree of logical-axis tuples, for a tree of
#: shapes or tensors (the reference's ``make_shardings``)
make_shardings = sh.make_specs


def _place(t, mesh, placements):
    """``t`` as a ``DTensor`` on ``placements``: a ``DTensor`` is
    redistributed (if it is not there already); a plain tensor, which every
    rank holds whole and equal, is cut into the rank's shard with no
    communication."""
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(placements):
            return t
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _tree_place(tree, mesh, placements):
    """:func:`_place` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_place(v, mesh, placements[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_place(v, mesh, p) for v, p in zip(tree, placements)]
    return _place(tree, mesh, placements)


def distribute_state(state: dict, rules: sh.Rules) -> dict:
    """A train state as ``DTensor``\\ s placed by :func:`state_axes` and
    ``rules`` over ``rules.mesh``; ``state`` holds whole tensors, the same
    on every rank (a one-device state)."""
    pl = make_shardings(rules, state_axes(state["params"]), state)
    return _tree_place(state, rules.mesh, pl)


def distribute_batch(batch: dict, rules: sh.Rules) -> dict:
    """A batch as ``DTensor``\\ s placed by :data:`BATCH_AXES`."""
    return {k: _place(v, rules.mesh, rules.placements(BATCH_AXES[k],
                                                      v.shape))
            for k, v in batch.items()}


def ce_chunks(rules: sh.Rules, batch: int) -> int:
    """The reference's CE chunking: one batch row per data shard at a time,
    ``B // dp`` chunks when that divides and exceeds 1."""
    dp = 1
    for ax in ("pod", "data"):
        dp *= rules.sizes.get(ax, 1)
    return batch // dp if batch % dp == 0 and batch // dp > 1 else 1


def jit_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, rules: sh.Rules,
                   params_shapes: dict, batch_specs: dict):
    """(step, state placements): ``step(state, batch) -> (state, metrics)``
    is :func:`make_train_step`'s eager step under ``rules`` on a state of
    ``DTensor``\\ s (:func:`distribute_state`) and a batch placed by
    :data:`BATCH_AXES` (whole tensors are cut, no communication).  The new
    state comes back on the state placements (the reference's
    ``out_shardings``); the metrics are whole 0-dim tensors."""
    shapes = {"params": params_shapes,
              "opt": {"m": params_shapes, "v": params_shapes, "step": ()}}
    state_pl = make_shardings(rules, state_axes(params_shapes), shapes)
    inner = make_train_step(cfg, opt_cfg, ce_chunks(
        rules, batch_specs["labels"].shape[0]))
    mesh = rules.mesh

    def step(state, batch):
        batch = distribute_batch(batch, rules)
        with sh.use_rules(rules), implicit_replication():
            state, metrics = inner(state, batch)
        state = _tree_place(state, mesh, state_pl)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return state, metrics

    return step, state_pl


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
