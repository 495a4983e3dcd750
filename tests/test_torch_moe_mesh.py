"""The MoE block under a mesh (``models/moe.py``), on the CPU over gloo
ranks (``launch.mesh.spawn_ranks``; the rank programs are in
``tests/_torch_moe_ranks.py``), at the MoE smoke configs (8 experts,
top-2) on weights initialised by the JAX package.

  * E-split (the expert dim divides the ``model`` axis: 4 and 2 experts a
    rank on meshes 2 and 4): the output is bitwise the unsharded port's, in
    f32 and bf16, float and int8 experts, with dropped copies and at a
    decode row; the unsharded run is made on the same rank, so both share
    its threads.
  * ``expert_mlp`` split (6 experts on 4 ranks): within 1e-6 relative
    error (max |err| / max |ref|) of the unsharded port in f32, and within
    the block's port-vs-JAX limit (``test_torch_moe.MOE_TOL``) of the JAX
    package's one-device block.
  * (data 2, model 2) and (data 2, model 3) meshes against the JAX
    package's own ``shard_map`` branches, run in a subprocess with
    ``--xla_force_host_platform_device_count=6``: the output within 1e-6
    relative error, the load-balance loss within 1e-6.  On (2, 3) the
    port splits ``expert_mlp`` (``d_ff_expert`` 48) where the JAX package
    pads 8 experts to 9 and splits them E-wise.  The load-balance loss
    over the data axis and its router gradient (averaged over ``data``)
    equal the single-device ones within 1e-6.
  * A ZeRO-1 train step of both MoE smoke configs on (data 2, model 2)
    against the JAX package's single-device step, at the limits of
    ``tests/test_torch_sharded_training.py``: f32 (the classic layout) the
    loss and ``grad_norm`` within 1e-5 relative, every updated parameter
    within 1e-4; bf16 ZeRO-1 the loss within 1e-3 relative.  As there,
    each reduced bf16 gradient slice is held within 2e-2 relative norm of
    the port's single-device step: the port's own single-device bf16 MoE
    gradients part from the JAX package's by up to 0.22 relative norm
    (qwen3-moe's router; near ties of the routing flip under the two
    frameworks' bf16 rounding), sharded or not.  The update through the
    optimizer alone is bitwise, the compute copy is the bf16 cast of the
    whole master, the expert stacks move between their placements through
    the whole tensor (``relayout``), and each rank's state bytes are those
    the dry run's placement arithmetic gives.
  * qwen3-moe's smoke config served on mesh 2 (``heads``, E-split): the
    Scheduler and ``prefill`` → ``greedy_decode`` give the unsharded
    port's tokens.

Each spawning test passes its ranks a timeout of at most 120 s.
"""
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxLM
from repro.models import moe as jax_moe
from repro.optim.adamw import AdamW as JaxAdamW
from repro.training.train_step import TrainState as JaxState
from repro.training.train_step import make_loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.bridge import params_from_numpy, shard_model
from repro_torch.core.quantization import QTensor
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.launch.sharding import (local_shape, model_param_shapes,
                                         take_shard, train_placement)
from repro_torch.models import moe
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import greedy_decode, prefill
from repro_torch.serving.scheduler import Scheduler
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             trainable)
from test_torch_bridge import numpy_tree, rel_err
from test_torch_moe import MOE_ARCHS, MOE_TOL, layer_params, moe_models

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_moe_ranks as ranks  # noqa: E402

RANK_TIMEOUT = 120
MESH_REL = 1e-6
LB_TOL = 1e-6
SRC = str(Path(__file__).resolve().parents[1] / "src")

# the block's variants: config overrides and whether the experts are int8
VARIANTS = {"default": ({}, False), "drops": ({"capacity_factor": 0.25},
                                              False),
            "int8": ({}, True)}
SHAPES = ((3, 40), (4, 1))
DTYPES = ("float32", "bfloat16")


def _x(b, s, d, seed=4):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _pair(arch, overrides, quantized):
    """(jax cfg, jax params, torch cfg, numpy tree) of the smoke config."""
    kw = dict(quant_proj="w8a8", quantize_experts=True) if quantized else \
        dict(quant_proj="none")
    jcfg, params, tcfg, _ = moe_models(arch, dtype="float32", **kw,
                                       **overrides)
    return jcfg, params, tcfg, numpy_tree(params)


def _serve_cases(world):
    cases = {}
    for arch in MOE_ARCHS:
        for variant, (overrides, quantized) in VARIANTS.items():
            _, _, tcfg, tree = _pair(arch, overrides, quantized)
            for dtype in DTYPES:
                for b, s in SHAPES:
                    cases[(arch, variant, dtype, b, s)] = (
                        tree, tcfg, _x(b, s, tcfg.d_model), dtype, False)
    if world == 4:
        for arch in MOE_ARCHS:
            for variant, (overrides, quantized) in VARIANTS.items():
                _, _, tcfg, tree = _pair(arch, dict(overrides, n_experts=6),
                                         quantized)
                cases[(arch, "six", variant)] = (
                    tree, tcfg, _x(3, 40, tcfg.d_model), "float32", False)
            _, _, tcfg, tree = _pair(arch, {"n_shared_experts": 1}, False)
            cases[(arch, "shared")] = (tree, tcfg, _x(3, 40, tcfg.d_model),
                                       "float32", False)
    return cases


@functools.lru_cache(maxsize=None)
def _serve(world):
    return spawn_ranks(ranks.moe_block_rank, world, backend="gloo",
                       device="cpu", args=(_serve_cases(world),),
                       timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_e_split_is_bitwise_the_unsharded_port(world, arch, variant, dtype):
    quantized = VARIANTS[variant][1]
    for r, run in enumerate(_serve(world)):
        for b, s in SHAPES:
            rec = run[(arch, variant, dtype, b, s)]
            assert rec["split"] == "experts"
            assert rec["stacks"]["gate"][0] == 8 // world
            assert rec["stacks"]["down"][0] == 8 // world
            if quantized:       # (E, 1, N) scales sliced with their values
                assert rec["scales"]["gate"][0] == 8 // world
            assert torch.equal(rec["got_y"], rec["ref_y"]), (r, b, s)
            assert rec["got_lb"] == rec["ref_lb"]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_mlp_split_six_experts_on_four_ranks(arch, variant):
    overrides, quantized = VARIANTS[variant]
    jcfg, params, tcfg, _ = _pair(arch, dict(overrides, n_experts=6),
                                  quantized)
    x = _x(3, 40, tcfg.d_model)
    yj, _ = jax_moe.apply_moe(layer_params(params), jnp.asarray(x), jcfg)
    f = tcfg.d_ff_expert
    for run in _serve(4):
        rec = run[(arch, "six", variant)]
        assert rec["split"] == "expert_mlp"
        assert rec["stacks"] == {"gate": (6, tcfg.d_model, f // 4),
                                 "up": (6, tcfg.d_model, f // 4),
                                 "down": (6, f // 4, tcfg.d_model)}
        if quantized:   # down's scales are per output channel: whole
            assert rec["scales"] == {"gate": (6, 1, f // 4),
                                     "up": (6, 1, f // 4),
                                     "down": (6, 1, tcfg.d_model)}
        assert rel_err(rec["got_y"], rec["ref_y"]) <= MESH_REL
        assert rel_err(rec["got_y"], np.asarray(yj)) <= MOE_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shared_experts_under_a_mesh(arch):
    """The shared FFN is tensor-parallel as a dense FFN (its row-parallel
    sum is not the unsharded one's order)."""
    for run in _serve(4):
        rec = run[(arch, "shared")]
        assert rec["split"] == "experts"
        assert rel_err(rec["got_y"], rec["ref_y"]) <= MESH_REL


# ---------------------------------------------------------------------------
# (data, model) meshes against the JAX package's shard_map branches
# ---------------------------------------------------------------------------
DP_MESHES = {(2, 2): {}, (2, 3): {"d_ff_expert": 48}}
DP_X = (4, 12)

JAX_PROG = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.launch.sharding import activate_sharding
    from repro.models.moe import apply_moe
    from repro.models.transformer import init_model

    todo = json.loads(sys.argv[1])
    out = {}
    for key, arch, (d, m), overrides, x_shape in todo:
        cfg = get_smoke_config(arch).replace(quant_proj="none",
                                             dtype="float32", **overrides)
        params = init_model(jax.random.PRNGKey(0), cfg)
        p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        x = np.random.default_rng(4).normal(size=x_shape).astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        with activate_sharding(mesh):
            y, aux = apply_moe(p, jnp.asarray(x), cfg)
        out[key + "|y"] = np.asarray(y)
        out[key + "|lb"] = np.asarray(aux["load_balance_loss"])
    np.savez(sys.argv[2], **out)
""")


@functools.lru_cache(maxsize=None)
def _jax_branches():
    """The JAX package's ``apply_moe`` on each (data, model) mesh, in a
    subprocess with 6 host devices: {(arch, mesh): (y, lb)}."""
    todo = [(f"{arch}|{d}x{m}", arch, (d, m), overrides,
             DP_X + (paired_d_model(arch),))
            for arch in MOE_ARCHS for (d, m), overrides in DP_MESHES.items()]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.npz")
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", JAX_PROG, json.dumps(todo),
                        path], check=True, env=env, timeout=600)
        got = dict(np.load(path))
    return {(arch, mesh): (got[f"{arch}|{mesh[0]}x{mesh[1]}|y"],
                           float(got[f"{arch}|{mesh[0]}x{mesh[1]}|lb"]))
            for arch in MOE_ARCHS for mesh in DP_MESHES}


def paired_d_model(arch):
    return _pair(arch, {}, False)[2].d_model


@functools.lru_cache(maxsize=None)
def _dp(data, model):
    cases = {}
    for arch in MOE_ARCHS:
        _, _, tcfg, tree = _pair(arch, DP_MESHES[(data, model)], False)
        cases[arch] = (tree, tcfg, _x(*DP_X, tcfg.d_model), "float32", True)
    return spawn_ranks(ranks.moe_block_rank, data * model, data=data,
                       backend="gloo", device="cpu", args=(cases,),
                       timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("mesh", list(DP_MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_data_model_mesh_matches_the_jax_shard_map_branch(arch, mesh):
    data, model = mesh
    y_jax, lb_jax = _jax_branches()[(arch, mesh)]
    runs = _dp(data, model)
    rows = DP_X[0] // data
    for g, run in enumerate(runs):
        rec = run[arch]
        assert rec["split"] == ("experts" if model == 2 else "expert_mlp")
        d = g // model
        want = y_jax[d * rows:(d + 1) * rows]
        assert rel_err(rec["got_y"], want) <= MESH_REL, g
        assert abs(rec["got_lb"] - lb_jax) <= LB_TOL
        if model == 2:      # E-split: the rows are the unsharded port's
            assert torch.equal(rec["got_y"], rec["ref_y"])


@pytest.mark.parametrize("mesh", list(DP_MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_load_balance_loss_and_router_gradient_over_data(arch, mesh):
    for run in _dp(*mesh):
        rec = run[arch]
        assert abs(rec["got_lb"] - rec["ref_lb"]) <= LB_TOL
        assert rel_err(rec["got_router_grad"],
                       rec["ref_router_grad"]) <= MESH_REL
    # every rank holds the same bits of the global loss
    assert len({run[arch]["got_lb"] for run in _dp(*mesh)}) == 1


# ---------------------------------------------------------------------------
# ZeRO-1 training on (data 2, model 2)
# ---------------------------------------------------------------------------
BATCH, SEQ, LR = 4, 64, 1e-3
TOL_LOSS = TOL_GNORM = 1e-5
TOL_PARAM = 1e-4
BF16_LOSS, BF16_GRAD = 1e-3, 2e-2


def _rank_mesh(data, model, g):
    d, m = divmod(g, model)
    return Mesh(model, m, data=data, data_rank=d, device="cpu",
                axis_names=("data", "model"))


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.lru_cache(maxsize=None)
def _train(arch):
    """The JAX package's single-device f32 step and bf16 loss, the port's
    single-device bf16 ZeRO-1 gradients, and the port's (data 2, model 2)
    spawn."""
    jcfg, params, tcfg, tree = _pair(arch, {}, False)
    batch = JaxLM(jcfg.vocab_size, BATCH, SEQ, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = JaxAdamW(learning_rate=LR)
    jstate, jm = jax.jit(jax_train_step(jcfg, jopt))(
        JaxState.create(params, jopt), jb)
    after = trainable(params_from_numpy(numpy_tree(jstate.params), tcfg,
                                        device="cpu"))
    bcfg = jcfg.replace(dtype="bfloat16")
    (bl, _), _ = jax.jit(jax.value_and_grad(jax_loss_fn(bcfg),
                                            has_aux=True))(params, jb)
    # the port's single-device bf16 ZeRO-1 step: the gradients AdamW takes
    opt = AdamW(learning_rate=LR, clip_norm=None)
    grads = {}
    update = opt.update

    def recorded(g, st, p, **kw):
        grads.update({n: x.float().clone() for n, x in g.items()})
        return update(g, st, p, **kw)

    object.__setattr__(opt, "update", recorded)
    tb = tcfg.replace(dtype="bfloat16")
    make_train_step(tb, opt)(
        TrainState.create(params_from_numpy(tree, tb, device="cpu"), opt,
                          zero1=True),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    runs = spawn_ranks(ranks.moe_train_rank, 4, data=2, backend="gloo",
                       device="cpu", args=(tree, tcfg, batch, LR),
                       timeout=RANK_TIMEOUT)
    return {"metrics": {k: float(v) for k, v in jm.items()}, "after": after,
            "bf16_loss": float(bl), "bf16_grads": grads, "runs": runs,
            "shapes": model_param_shapes(params_from_numpy(tree, tcfg,
                                                           device="cpu"))}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_f32_step_on_2x2_matches_the_jax_single_device_step(arch):
    t = _train(arch)
    for g, run in enumerate(t["runs"]):
        m = run["metrics"]
        assert abs(m["loss"] - t["metrics"]["loss"]) \
            <= TOL_LOSS * abs(t["metrics"]["loss"]), g
        assert abs(m["grad_norm"] - t["metrics"]["grad_norm"]) \
            <= TOL_GNORM * t["metrics"]["grad_norm"], g
        mesh = _rank_mesh(2, 2, g)
        for name, got in run["params"].items():
            want = take_shard(t["after"][name].float(), run["compute"][name],
                              mesh)
            assert float((got - want).abs().max()) <= TOL_PARAM, (g, name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_zero1_step_on_2x2_matches_the_jax_single_device_step(arch):
    t = _train(arch)
    runs = t["runs"]
    stacks = {n for n in t["shapes"] if ".experts." in n}
    for g, run in enumerate(runs):
        b = run["bf16"]
        assert set(run["relayout"]) == stacks
        assert abs(b["metrics"]["loss"] - t["bf16_loss"]) \
            <= BF16_LOSS * abs(t["bf16_loss"])
        mesh = _rank_mesh(2, 2, g)
        fsdp = run["fsdp"]
        for name, got in b["grads"].items():
            want = take_shard(t["bf16_grads"][name].float(), fsdp[name], mesh)
            assert got.shape == want.shape, name
            assert _rel_norm(got, want) <= BF16_GRAD, (g, name)
        # the update through the optimizer alone, bitwise
        opt = AdamW(learning_rate=LR, clip_norm=None)
        p = {n: b["master0"][n].clone() for n in b["grads"]}
        opt.update({n: x.clone() for n, x in b["grads"].items()},
                   opt.init(p), p)
        for name, x in p.items():
            assert torch.equal(x, b["master"][name]), (g, name)
        # the state bytes the dry run's arithmetic gives (the compute copy
        # in bf16 where its JAX leaf has >= 2 dims)
        want_bytes = 0
        for name, shape in t["shapes"].items():
            bf16 = b["compute_dtypes"][name] == "torch.bfloat16"
            want_bytes += math.prod(local_shape(shape, run["compute"][name],
                                                mesh)) * (2 if bf16 else 0)
            want_bytes += 3 * 4 * math.prod(local_shape(shape, fsdp[name],
                                                        mesh))
        assert run["state_bytes"] == want_bytes
    # the compute copy: the bf16 cast of the whole master, the same bits on
    # both data ranks of a model slice
    for g, run in enumerate(runs):
        mesh = _rank_mesh(2, 2, g)
        for name, x in run["bf16"]["compute"].items():
            assert torch.equal(x, runs[(g + 2) % 4]["bf16"]["compute"][name])
            if run["bf16"]["compute_dtypes"][name] != "torch.bfloat16":
                continue
            whole = torch.zeros(t["shapes"][name])
            for gg, other in enumerate(runs):
                m_gg = _rank_mesh(2, 2, gg)
                take_shard(whole, run["fsdp"][name], m_gg).copy_(
                    other["bf16"]["master"][name])
            want = take_shard(whole.bfloat16().float(),
                              run["compute"][name], mesh)
            assert torch.equal(x, want), (g, name)


def test_train_placement_relayouts_the_expert_stacks():
    """Under the FSDP rules the stacks rest split over ``data`` by expert
    and over ``model`` by ``expert_mlp``; the compute copy is E-split over
    ``model``: no dim of one is a further split of the other's."""
    _, _, tcfg, tree = _pair("qwen3_moe_30b_a3b", {}, False)
    shapes = model_param_shapes(params_from_numpy(tree, tcfg, device="cpu"))
    p = train_placement(shapes, _rank_mesh(2, 2, 3))
    name = "layers.0.moe.experts.gate"
    assert p.compute[name] == ("model", None, None)
    assert p.fsdp[name] == ("data", None, "model")
    assert name in p.relayout and p.fsdp_dim[name] is None
    assert p.fsdp_dim["layers.0.moe.router.w"] == (0, ("data",))
    assert {n for n in shapes if ".experts." in n} == set(p.relayout)


# ---------------------------------------------------------------------------
# serving through the entry points
# ---------------------------------------------------------------------------
SCHED_PROMPTS = ((9, 1), (13, 2), (5, 3), (11, 4))
SCHED_BUDGETS = [4, 5, 3, 4]
CACHE_KW = dict(layout="paged", alloc="dynamic", page_size=4, pool_pages=24)
SCHED_KW = dict(slots=3, max_len=64, bucket=4)
GREEDY_STEPS = 5


def _prompts(vocab):
    return [np.random.default_rng(seed).integers(0, vocab, n)
            for n, seed in SCHED_PROMPTS]


def test_serving_on_mesh_2_gives_the_unsharded_tokens():
    _, _, tcfg, tree = _pair("qwen3_moe_30b_a3b", {}, False)
    prompts = _prompts(tcfg.vocab_size)
    runs = spawn_ranks(ranks.moe_sched_rank, 2, backend="gloo", device="cpu",
                       args=(tree, tcfg, prompts, SCHED_BUDGETS, CACHE_KW,
                             SCHED_KW, GREEDY_STEPS), timeout=RANK_TIMEOUT)
    model = params_from_numpy(tree, tcfg, device="cpu")
    sched = Scheduler(model, tcfg, config=CacheConfig(**CACHE_KW),
                      device="cpu", **SCHED_KW)
    rids = [sched.submit(p, b) for p, b in zip(prompts, SCHED_BUDGETS)]
    lens = torch.tensor([len(p) for p in prompts])
    padded = torch.zeros((len(prompts), int(lens.max())), dtype=torch.long)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.as_tensor(p)
    with torch.inference_mode():
        out = sched.run(max_ticks=200)
        cache = init_cache(tcfg, len(prompts),
                           int(lens.max()) + GREEDY_STEPS + 4, torch.float32,
                           CacheConfig(layout="paged", page_size=4),
                           device="cpu")
        logits, cache = prefill(model, cache, padded, lens, tcfg)
        greedy, _ = greedy_decode(model, cache, logits.argmax(-1)[:, None],
                                  None, GREEDY_STEPS, tcfg)
    for run in runs:
        assert run["kv_shard"] == "heads"
        assert run["splits"] == ["experts"] * tcfg.n_layers
        for got, want in zip(run["tokens"], [out[r] for r in rids]):
            np.testing.assert_array_equal(got, want)
        assert torch.equal(run["greedy"], greedy)


# ---------------------------------------------------------------------------
# in-process: the placement of the stacks, and what raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_experts,world", [(8, 2), (6, 4)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_model_slices_quantized_stacks(arch, n_experts, world):
    """int8 experts are quantized whole, then sliced with their scales; the
    router stays whole."""
    _, _, tcfg, tree = _pair(arch, {"n_experts": n_experts}, True)
    whole = params_from_numpy(tree, tcfg, device="cpu").layers[0].moe
    f = tcfg.d_ff_expert
    for r in range(world):
        block = shard_model(params_from_numpy(tree, tcfg, device="cpu"),
                            Mesh(world, r, device="cpu")).layers[0].moe
        assert block.mesh.rank == r
        assert torch.equal(block.router.w, whole.router.w)
        for name in moe.Experts.NAMES:
            w, q = block.experts.weight(name), whole.experts.weight(name)
            assert isinstance(w, QTensor) and w.values.dtype == torch.int8
            if n_experts % world == 0:
                n = n_experts // world
                sl = (slice(r * n, (r + 1) * n),)
                assert torch.equal(w.values, q.values[sl])
                assert torch.equal(w.scale, q.scale[sl])
            elif name == "down":
                n = f // world
                assert torch.equal(w.values, q.values[:, r * n:(r + 1) * n])
                assert torch.equal(w.scale, q.scale)
            else:
                n = f // world
                assert torch.equal(w.values, q.values[..., r * n:(r + 1) * n])
                assert torch.equal(w.scale, q.scale[..., r * n:(r + 1) * n])


def test_local_moe_impl_on_a_mesh_raises():
    _, _, tcfg, tree = _pair("qwen3_moe_30b_a3b", {}, False)
    model = shard_model(params_from_numpy(tree, tcfg, device="cpu"),
                        Mesh(2, 0, device="cpu"))
    with pytest.raises(NotImplementedError, match="moe_impl='local'"):
        moe.apply_moe(model.layers[0].moe, torch.zeros(1, 2, tcfg.d_model),
                      tcfg.replace(moe_impl="local"))


@pytest.mark.parametrize("impl", ["sharded", "local"])
def test_moe_impl_on_one_device_is_the_local_path(impl):
    """Without a mesh of more than one rank every ``moe_impl`` is the
    local dispatch (the JAX package's, with no mesh active)."""
    _, _, tcfg, tree = _pair("qwen3_moe_30b_a3b", {}, False)
    block = params_from_numpy(tree, tcfg, device="cpu").layers[0].moe
    x = torch.from_numpy(_x(2, 12, tcfg.d_model))
    want, _ = moe.apply_moe(block, x, tcfg)
    got, _ = moe.apply_moe(block, x, tcfg.replace(moe_impl=impl))
    assert torch.equal(got, want)
