"""PyTorch port vs the JAX reference: the launch layer (``repro_torch.launch``
against ``repro.launch``) on the CPU.

* ``model_flops`` and ``active_params`` equal the reference's exactly, for
  every architecture and input shape.
* ``Rules.spec`` equals the reference's on a (2, 2, 2) pod/data/model
  stand-in (both packages' ``Rules`` read only ``mesh.shape``), for every
  parameter of every architecture (full and smoke configs) and every
  decode-cache entry, under the baseline rules and every variant's rule
  builder.  The reference stacks a period's layers behind a leading
  ``"layers"`` axis; its spec loses that entry before the comparison.
* The solver-step traffic model, ``traffic_bytes`` of the eight fused
  bodies, ``CG_BASELINE_PASSES`` and the Poisson ladder equal the
  reference's.
* On two gloo ranks (spawned, a ``FileStore``; ``_torch_launch_ranks``),
  from the reference's initial state on the reference's batches:
  ``jit_train_step`` on a ``distribute_state`` state, two steps, f32, on a
  (data 2, model 1) mesh, a (data 1, model 2) mesh, with H 6, K 3 on
  (1, 2), where the kv heads replicate and each rank gathers its query
  heads' kv heads, and on (2, 1) with full remat, where each layer's
  parameters are gathered inside its checkpointed forward — against the reference's ``train_step`` with the same
  CE chunking, and against the port's one-device ``make_train_step``; and
  eight ``jit_serve_step`` decode steps on (1, 2) from the reference's
  weights against the reference's greedy tokens and the port's unsharded
  ones.
"""
import contextlib
import dataclasses
import functools
import pickle
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.configs import poisson2d as jpoisson
from repro.configs.base import SHAPES as JSHAPES
from repro.data.tokens import synthetic_batch as jbatch
from repro.kernels import solve_step as jfk
from repro.launch import roofline as jR
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.launch import variants as jV
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, smoke_variant
from repro_torch.configs import poisson2d as tpoisson
from repro_torch.kernels import solve_step as tfk
from repro_torch.launch import roofline as R
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.launch import variants as tV
from repro_torch.models import transformer as tT
from repro_torch.models.convert import model_from_jax, state_from_jax

import _torch_launch_ranks as ranks
from _torch_parity import two_ranks
from test_torch_serve_lm import _reference_greedy as reference_greedy

RANK_TIMEOUT = 180
TOL_REF = 2e-4                 # two steps of a 1e-4 gradient bound
MESH = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
BODIES = ("fused_cg_update", "fused_cg_direction", "fused_cg_halfstep",
          "fused_cheb_step", "fused_dots2", "fused_bicg_p", "fused_bicg_s",
          "fused_bicg_tail")


# ---------------------------------------------------------------------------
# FLOP and byte models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert R.active_params(cfg) == jR.active_params(jcfg)
    for name, shape in SHAPES.items():
        assert R.model_flops(cfg, shape) == jR.model_flops(
            jcfg, JSHAPES[name]), name


@pytest.mark.parametrize("itemsize", [4, 8])
def test_solver_traffic_matches_reference(itemsize):
    for n in (1, 1000, 65536):
        assert R.solver_step_traffic(n, itemsize) == jR.solver_step_traffic(
            n, itemsize)
        for body in BODIES:
            assert tfk.traffic_bytes(getattr(tfk, body), n, itemsize) == \
                jfk.traffic_bytes(getattr(jfk, body), n, itemsize), body
    assert R.CG_BASELINE_PASSES == jR.CG_BASELINE_PASSES


def test_fused_step_savings_gate_and_eager_baseline_bytes():
    """The model's ratio passes the gate; the unfused eager sequence moves,
    each op's inputs read and outputs written once: three dots (2n each),
    four scalar·vector products (2n), four vector sums and the diagonal
    scale (3n) — 24n — and 12 scalars."""
    res = R.assert_fused_step_savings()
    model = jR.solver_step_traffic(65536, 8)
    assert {k: v for k, v in res.items()
            if k != "measured_baseline_bytes"} == model
    n, b = 1000, 8
    assert R.measured_baseline_bytes(n) == (24 * n + 12) * b


def test_poisson_sizes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tpoisson.SIZES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jpoisson.SIZES.items()}
    assert dataclasses.asdict(tpoisson.PoissonConfig(ng=7)) == \
        dataclasses.asdict(jpoisson.PoissonConfig(ng=7))


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _ref_param_path(cfg, name):
    """(the reference's path of the port's parameter ``name``, whether it
    lies in a stacked period)."""
    parts = name.split(".")
    period = len(cfg.layer_pattern)
    n_full = cfg.n_layers // period
    if parts[0] == "layers":
        n = int(parts[1])
        if n < n_full * period:
            return ("stack", f"l{n % period}", *parts[2:]), True
        return ("rem", f"l{n - n_full * period}", *parts[2:]), False
    if parts[:2] == ["encoder", "layers"]:
        return ("encoder", "stack", *parts[3:]), True
    return tuple(parts), False


def _ref_layer_caches(cfg, state):
    """The reference's decode state as one {entry: (leaf, stacked)} a
    layer, in the port's layer order."""
    period = len(cfg.layer_pattern)
    n_full = cfg.n_layers // period
    out = []
    for n in range(cfg.n_layers):
        stacked = n < n_full * period
        node = (state["stack"][f"l{n % period}"] if stacked
                else state["rem"][f"l{n - n_full * period}"])
        out.append({path[-1]: (leaf, stacked) for path, leaf in _flat(node)})
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_spec_matches_reference(arch, smoke):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if smoke:
        cfg, jcfg = smoke_variant(cfg), jsmoke(jcfg)
    # the reference's builders, by the port's names
    jbuild = {name: jV.VARIANTS[name][0] for name in tV.VARIANTS}
    tshapes = tT.param_shapes(cfg)
    taxes = tT.param_axes(tshapes)
    jshapes = jT.param_shapes(jcfg)
    jaxes = dict(_flat(jT.param_axes(jshapes)))
    jleaves = dict(_flat(jshapes))
    # every reference parameter has its counterparts, and only those
    assert {_ref_param_path(cfg, n)[0] for n in tshapes} == set(jleaves)
    dshape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                 global_batch=8) if smoke else \
        SHAPES["decode_32k"]
    jdshape = dataclasses.replace(JSHAPES["decode_32k"],
                                  seq_len=dshape.seq_len,
                                  global_batch=dshape.global_batch)
    tstate = tspecs.decode_specs(cfg, dshape)["state"]
    tcax = tT.cache_axes(tstate)
    jstate = jspecs.decode_specs(jcfg, jdshape)["state"]
    jlayers = _ref_layer_caches(jcfg, jstate)
    jcax = _ref_layer_caches(jcfg, jT.cache_axes(jstate))
    for vname, tbuilder in tV.VARIANTS.items():
        trules, jrules = tbuilder[0](MESH), jbuild[vname](MESH)
        assert trules.table == jrules.table, vname
        for name, shape in tshapes.items():
            path, stacked = _ref_param_path(cfg, name)
            jshape = jleaves[path].shape
            jspec = tuple(jrules.spec(jaxes[path], jshape))
            if stacked:
                jshape, jspec = jshape[1:], jspec[1:]
            assert tuple(shape) == tuple(jshape), name
            assert trules.spec(taxes[name], shape) == jspec, (vname, name)
        for n, layer in enumerate(tstate["layers"]):
            assert set(layer) == set(jlayers[n]), n
            for key, t in layer.items():
                leaf, stacked = jlayers[n][key]
                jspec = tuple(jrules.spec(jcax[n][key][0], leaf.shape))
                jshape = leaf.shape
                if stacked:
                    jshape, jspec = jshape[1:], jspec[1:]
                assert tuple(t.shape) == tuple(jshape), (n, key)
                assert trules.spec(tcax["layers"][n][key], t.shape) == \
                    jspec, (vname, n, key)


def test_spec_placements():
    """One ``Placement`` a mesh dimension; a tuple of axes shards one
    dimension outer to inner in mesh order; a mesh axis on two dimensions
    or a tuple out of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.spec_placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.spec_placements(mesh, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="shards dimensions"):
        sh.spec_placements(mesh, ("model", "model"))
    with pytest.raises(ValueError, match="order"):
        sh.spec_placements(mesh, (("data", "pod"),))


def test_specs_match_reference_shapes():
    """``batch_specs`` / ``decode_specs`` stand-ins: the reference's shapes
    and dtypes (the decode position is a Python int here)."""
    shape = SHAPES["train_4k"]
    for arch in ("llama3.2-1b", "whisper-medium", "qwen2-vl-72b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        t = tspecs.batch_specs(cfg, shape)
        j = jspecs.batch_specs(jcfg, JSHAPES["train_4k"])
        assert set(t) == set(j)
        for k in t:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape), (arch, k)
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k
    d = tspecs.input_specs(get_config("llama3.2-1b"), SHAPES["decode_32k"])
    assert d["pos"] == 0 and tuple(d["token"].shape) == (128, 1)


# ---------------------------------------------------------------------------
# the sharded steps on two gloo ranks
# ---------------------------------------------------------------------------

def _ref_init(H, K):
    jcfg = jsmoke(jget_config("llama3.2-1b"))
    if H is not None:
        jcfg = dataclasses.replace(jcfg, n_heads=H, n_kv_heads=K)
    params = jax.jit(functools.partial(jT.init_params, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, {"params": params, "opt": jadamw.init_opt_state(params)}


@pytest.fixture(scope="module", autouse=True)
def started_ranks(tmp_path_factory):
    """Starts the two ranks before the module's first test, so that they
    run beside the tests that need none: the reference's initial states,
    batches and prompts go to them as numpy, and the reference's own steps
    run on a thread of this process meanwhile.  Yields (the future of
    :func:`_reference_runs`, the inputs, where rank 0 writes, the stack
    whose closing joins the ranks)."""
    tmp = tmp_path_factory.mktemp("launch")
    init = {}
    inputs = {"states": {}, "batches": {}}
    for label, _, H, K, _ in ranks.TRAIN_CASES:
        if (H, K) not in init:
            init[H, K] = _ref_init(H, K)
        jcfg, jstate = init[H, K]
        inputs["states"][label] = jax.tree.map(np.asarray, jstate)
        inputs["batches"][label] = [
            {k: np.asarray(v) for k, v in
             jbatch(0, s, ranks.B, ranks.SEQ + 1, jcfg.vocab).items()}
            for s in range(ranks.STEPS)]
    inputs["prompts"] = np.random.default_rng(1).integers(
        0, init[None, None][0].vocab, ranks.DECODE[:2]).astype(np.int32)
    in_path = tmp / "inputs.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    with contextlib.ExitStack() as stack:
        out_path = stack.enter_context(two_ranks(
            ranks.rank_main, tmp, "rank0.npz", RANK_TIMEOUT,
            (str(in_path),)))
        pool = stack.enter_context(ThreadPoolExecutor(1))
        ref = pool.submit(_reference_runs, init, inputs)
        yield ref, inputs, out_path, stack


def _reference_runs(init, inputs):
    """Two of the reference's ``train_step`` a case, with the CE chunking
    its ``jit_train_step`` would choose, and its greedy decoding."""
    ref = {}
    for label, mesh, H, K, remat in ranks.TRAIN_CASES:
        jcfg, jstate = init[H, K]
        jcfg = dataclasses.replace(jcfg, remat=remat)
        step = jax.jit(jtrain.make_train_step(
            jcfg, jadamw.AdamWConfig(warmup_steps=1),
            num_ce_chunks=ranks.ce_chunks(mesh)))
        losses = []
        for b in inputs["batches"][label]:
            jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        ref[label] = (losses, jax.tree.map(np.asarray, jstate))
    jcfg, jstate = init[None, None]
    ref["decode"] = reference_greedy(jcfg, jstate["params"],
                                     inputs["prompts"], ranks.DECODE[2])
    return ref


@pytest.fixture(scope="module")
def launch_runs(started_ranks):
    """(rank 0's results, the reference's, the inputs both were given)."""
    ref, inputs, out_path, stack = started_ranks
    ref = ref.result()
    stack.close()                      # both ranks joined and exited 0
    return dict(np.load(out_path)), ref, inputs


def _rank0(runs, label):
    return {k.split(":", 1)[1]: v for k, v in runs[0].items()
            if k.startswith(label + ":")}


def _state_groups(state):
    return {"params": state["params"], "m": state["opt"]["m"],
            "v": state["opt"]["v"]}


def _worst(got, tree):
    """(max |got - tree| over a group, the group's max |x|)."""
    worst = max(float(np.abs(got[k] - t.numpy()).max())
                for k, t in tree.items())
    return worst, max(float(t.abs().max()) for t in tree.values())


@pytest.mark.parametrize("label,mesh,H,K,remat", ranks.TRAIN_CASES,
                         ids=[c[0] for c in ranks.TRAIN_CASES])
def test_sharded_train_step_matches_reference(launch_runs, label, mesh, H,
                                              K, remat):
    """Two sharded steps from the reference's initial state on the
    reference's batches against two of the reference's ``train_step`` with
    the same CE chunking: the losses within 1e-5 relative; params, m and v
    (mapped to the port's names) within TOL_REF of the group's max |x|.
    The port's gradients hold to the reference's within 1e-4 of a tensor's
    max (``test_torch_train``); two AdamW steps carry that into the moments
    and, through m/√v where a gradient nearly vanishes, into the
    parameters (6.0e-5 of the group's max here, on every mesh)."""
    got = _rank0(launch_runs, label)
    losses, jstate = launch_runs[1][label]
    assert int(got["ce_chunks"]) == ranks.ce_chunks(mesh)
    for s, want in enumerate(losses):
        assert abs(float(got[f"loss{s}"]) - want) <= 1e-5 * abs(want), s
    want = state_from_jax(ranks.smoke(H, K, remat), jstate, device="cpu")
    for group, tree in _state_groups(want).items():
        worst, scale = _worst({k.split("/", 1)[1]: v for k, v in got.items()
                               if k.startswith(group + "/")}, tree)
        assert worst <= TOL_REF * scale, (group, worst, scale)


def _one_device(label, cfg, ce_chunks, inputs):
    state = state_from_jax(cfg, inputs["states"][label], device="cpu")
    step = ttrain.make_train_step(cfg, ranks.opt_config(), ce_chunks)
    losses = []
    for b in inputs["batches"][label]:
        state, m = step(state, ranks.torch_batch(b))
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("label,mesh,H,K,remat", ranks.TRAIN_CASES,
                         ids=[c[0] for c in ranks.TRAIN_CASES])
def test_sharded_train_step_matches_one_device(launch_runs, label, mesh, H,
                                               K, remat):
    """The same two steps against the port's one-device ``make_train_step``
    on the same inputs: the losses within 1e-6 relative, and every group of
    the state within 1e-5 of that group's max |x|.  The bound is on the
    group's scale because AdamW's m/√v turns the last-bit difference of a
    reordered sum into a larger relative one where a gradient nearly
    vanishes (up to 1.6e-5 of a tensor's own max here)."""
    got = _rank0(launch_runs, label)
    state, losses = _one_device(label, ranks.smoke(H, K, remat),
                                int(got["ce_chunks"]), launch_runs[2])
    for s, want in enumerate(losses):
        assert abs(float(got[f"loss{s}"]) - want) <= 1e-6 * abs(want), s
    for group, tree in _state_groups(state).items():
        worst, scale = _worst({k.split("/", 1)[1]: v for k, v in got.items()
                               if k.startswith(group + "/")}, tree)
        assert worst <= 1e-5 * scale, (group, worst, scale)


def test_sharded_decode_matches_reference_tokens(launch_runs):
    """Eight sharded decode steps from the reference's weights give the
    reference's greedy tokens."""
    np.testing.assert_array_equal(launch_runs[0]["decode:tokens"],
                                  launch_runs[1]["decode"])


def test_sharded_decode_matches_unsharded_tokens(launch_runs):
    from repro_torch.launch import serve
    model = model_from_jax(ranks.smoke(),
                           launch_runs[2]["states"]["model2"]["params"],
                           device="cpu")
    Bd, P, G = ranks.DECODE
    want, _ = serve.greedy_decode(
        model, torch.tensor(launch_runs[2]["prompts"]), G)
    np.testing.assert_array_equal(launch_runs[0]["decode:tokens"],
                                  want.numpy())
    np.testing.assert_array_equal(launch_runs[0]["decode:cpos"],
                                  np.arange(P + G - 1).tolist() + [-1])
