"""Carry the reference's LM weights across as plain arrays.

The port imports nothing of the JAX package: a caller that holds the
reference's parameter pytree hands it over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``).  The reference stacks the layers of
each period on a leading axis under ``params["stack"]["l{i}"]`` and keeps
the remainder under ``params["rem"]``; the port's layer
``p·len(pattern) + i`` is the stack's slice ``p`` of ``l{i}``, and the
remainder follows.  Tied embeddings have no ``unembed`` on either side.
An encoder-decoder's ``params["encoder"]["stack"]`` is stacked over its
``n_enc_layers`` and goes to ``encoder.layers.{n}``, its ``final_norm`` to
``encoder.final_norm``.  A training state carries across the same way
(:func:`state_from_jax`), so a reference checkpoint resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import Transformer


def _flat(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _flat(name, v, out)
        else:
            out[name] = np.asarray(v)


def params_from_jax(cfg: ModelConfig, params_np: dict) -> dict:
    """The port's ``state_dict`` (CPU tensors) for the reference's params."""
    period = len(cfg.layer_pattern)
    n_full = cfg.n_layers // period
    layers = []
    for p in range(n_full):
        for i in range(period):
            one = {}
            _flat("", params_np["stack"][f"l{i}"], one)
            layers.append({k: a[p] for k, a in one.items()})
    for i in range(cfg.n_layers - n_full * period):
        one = {}
        _flat("", params_np["rem"][f"l{i}"], one)
        layers.append(one)
    flat = {}
    _flat("embed", params_np["embed"], flat)
    _flat("final_norm", params_np["final_norm"], flat)
    for n, one in enumerate(layers):
        for k, a in one.items():
            flat[f"layers.{n}.{k}"] = a
    if cfg.enc_dec:
        enc = {}
        _flat("", params_np["encoder"]["stack"], enc)
        for n in range(cfg.n_enc_layers):
            for k, a in enc.items():
                flat[f"encoder.layers.{n}.{k}"] = a[n]
        _flat("encoder.final_norm", params_np["encoder"]["final_norm"], flat)
    return {k: torch.tensor(a) for k, a in flat.items()}


def model_from_jax(cfg: ModelConfig, params_np: dict, device=None
                   ) -> Transformer:
    """A ready :class:`Transformer` on ``device`` (``None`` → ``"cuda"``)
    holding the reference's weights."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(params_from_jax(cfg, params_np), strict=True)
    return model


def state_from_jax(cfg: ModelConfig, ref_state_np: dict, device=None
                   ) -> dict:
    """The port's training state (``launch.train``) for the reference's
    ``{"params", "opt": {"m", "v", "step"}}`` as numpy (e.g. its
    checkpoint's arrays unflattened): params, m and v mapped as
    :func:`params_from_jax` maps params, the step an int32 scalar, all on
    ``device`` (``None`` → ``"cuda"``)."""
    from ..core._device import resolve_device
    dev = resolve_device(device)
    opt = ref_state_np["opt"]
    to = lambda tree: {k: t.to(dev)  # noqa: E731
                       for k, t in params_from_jax(cfg, tree).items()}
    return {"params": to(ref_state_np["params"]),
            "opt": {"m": to(opt["m"]), "v": to(opt["v"]),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}
