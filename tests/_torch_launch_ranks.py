"""The sharded train and serve steps of ``repro_torch.launch`` on one rank
of a two-rank gloo group (imports neither jax nor the reference, so the
spawned ranks start quickly).  ``tests/test_torch_launch.py`` spawns two,
hands them the reference's initial states, batches and prompts as numpy
(a pickle at ``in_path``), and holds what rank 0 writes to the reference's
steps and to the port's one-device steps."""
import dataclasses
import pickle

import numpy as np
import torch

STEPS = 2
B, SEQ = 4, 32
DECODE = (2, 4, 5)                   # batch, prompt, generated: 8 steps
#: (label, mesh (data, model), H, K, remat): "h6k3" replicates K = 3 kv
#: heads on a 2-way model axis, so each rank gathers its query heads' kv
#: heads; "data2_remat" gathers each layer's data-sharded parameters inside
#: its checkpointed forward, and again in the recompute
TRAIN_CASES = (("data2", (2, 1), None, None, "none"),
               ("model2", (1, 2), None, None, "none"),
               ("h6k3", (1, 2), 6, 3, "none"),
               ("data2_remat", (2, 1), None, None, "full"))


def smoke(H=None, K=None, remat="none"):
    from repro_torch.configs import get_config, smoke_variant
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              remat=remat)
    if H is not None:
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K)
    return cfg


def opt_config():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(warmup_steps=1)


def ce_chunks(mesh_shape):
    """The reference's CE chunking for a (data, model) mesh: ``B // dp``
    chunks when that divides and exceeds 1."""
    dp = mesh_shape[0]
    return B // dp if B % dp == 0 and B // dp > 1 else 1


def torch_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _train_case(mesh_shape, H, K, remat, ref_state, batches):
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import state_from_jax
    from repro_torch.models.transformer import param_shapes
    cfg = smoke(H, K, remat)
    rules = sh.baseline_rules(make_host_mesh(mesh_shape, ("data", "model")))
    bs = [torch_batch(b) for b in batches]
    step, _ = T.jit_train_step(cfg, opt_config(), rules, param_shapes(cfg),
                               bs[0])
    state = T.distribute_state(state_from_jax(cfg, ref_state, device="cpu"),
                               rules)
    out = {}
    for s, b in enumerate(bs):
        state, m = step(state, b)
        out[f"loss{s}"] = m["loss"].numpy()
        out[f"grad_norm{s}"] = m["grad_norm"].numpy()
    out["ce_chunks"] = np.asarray(T.ce_chunks(rules, B))
    for group in ("params", "m", "v"):
        tree = state["params"] if group == "params" else state["opt"][group]
        for k, t in tree.items():
            out[f"{group}/{k}"] = t.full_tensor().numpy()
    return out


def _decode_case(ref_params, prompts):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve as SV
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import decode_specs
    from repro_torch.models.convert import model_from_jax
    from repro_torch.models.transformer import param_shapes
    cfg = smoke()
    Bd, P, G = DECODE
    rules = sh.baseline_rules(make_host_mesh((1, 2), ("data", "model")))
    model = model_from_jax(cfg, ref_params, device="cpu")
    specs = decode_specs(cfg, ShapeConfig("d", P + G, Bd, "decode"))
    step, _ = SV.jit_serve_step(cfg, rules, param_shapes(cfg), specs)
    params = SV.distribute_params(model, rules)
    state = SV.distribute_decode_state(model.init_decode_state(Bd, P + G),
                                       rules)
    pr = torch.tensor(prompts)
    tok, out = pr[:, :1], [pr[:, :1]]
    for t in range(P + G - 1):
        nxt, state = step(params, state, tok, t)
        tok = pr[:, t + 1:t + 2] if t + 1 < P else nxt.full_tensor()
        out.append(tok)
    seq = torch.cat(out, 1).numpy()
    # the ring was written on both ranks: cache slot t holds position t
    cpos = state["layers"][0]["pos"].full_tensor().numpy()
    return {"tokens": seq, "cpos": cpos}


def rank_main(rank, store_path, out_path, in_path):
    """``in_path`` holds ``{"states": {label: the reference's initial train
    state}, "batches": {label: [batch]}, "prompts": (B, P) int32}``, all
    numpy."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    try:
        res = {}
        for label, mesh_shape, H, K, remat in TRAIN_CASES:
            for k, v in _train_case(mesh_shape, H, K, remat,
                                    inputs["states"][label],
                                    inputs["batches"][label]).items():
                res[f"{label}:{k}"] = v
        for k, v in _decode_case(inputs["states"]["model2"]["params"],
                                 inputs["prompts"]).items():
            res[f"decode:{k}"] = v
        if rank == 0:
            np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()
