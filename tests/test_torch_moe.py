"""PyTorch port vs the JAX reference: the MoE layer (granite-moe, dbrx).

The reference's ``init_moe`` weights cross to the port's ``MoE`` as numpy;
the same numpy activations go through the reference's ``moe_mlp`` and the
port's, f32, at ``smoke_variant``'s capacity factor 8 (no copy dropped) and
at 1.0 (copies past an expert's capacity are dropped, which the test checks
happens).  y must agree to 1e-5 of its scale and the load-balance aux to
1e-6 relative; the routing (top-k expert ids) must be identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import _flat

from _torch_parity import assert_close


def _layer(arch, capacity_factor):
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              capacity_factor=capacity_factor)
    params = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    layer = tmoe.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {}
    _flat("", jax.tree.map(np.asarray, params), flat)
    layer.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                          strict=True)
    return jcfg, params, cfg, layer


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_layer_matches_reference(arch, capacity_factor):
    jcfg, params, cfg, layer = _layer(arch, capacity_factor)
    B, S = 2, 64
    x = np.random.default_rng(7).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_mlp(p, x, jcfg))(params, x)
    y, aux = tmoe.moe_mlp(layer, torch.tensor(x), cfg)
    jy = np.asarray(jy)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    assert_close(y, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # routing: identical expert ids; at factor 1.0 some copies are dropped
    _, _, idx = tmoe.route(layer, torch.tensor(x), cfg)
    jidx = jax.lax.top_k(jax.nn.softmax(x @ np.asarray(params["router"]),
                                        axis=-1), cfg.top_k)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    counts = np.stack([np.bincount(r, minlength=cfg.n_experts)
                       for r in idx.reshape(B, -1).numpy()])
    C = tmoe.moe_capacity(cfg, S)
    assert C == jmoe.moe_capacity(jcfg, S)
    assert (counts.max() > C) == (capacity_factor == 1.0)


def test_moe_capacity_matches_reference():
    for arch in ("granite-moe-1b-a400m", "dbrx-132b"):
        for cf in (1.0, 1.25, 8.0):
            cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
            jcfg = dataclasses.replace(jget_config(arch), capacity_factor=cf)
            for S in (1, 7, 448, 4096):
                assert tmoe.moe_capacity(cfg, S) == jmoe.moe_capacity(jcfg, S)
