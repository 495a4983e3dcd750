"""The SSM (mamba2) and hybrid (zamba2) families under a mesh
(``models/ssm.py``'s mesh path, ``bridge.shard_model`` on Mamba2 blocks,
the slot state split by ``serving/cache.py``), on the CPU over gloo ranks
(``launch.mesh.spawn_ranks``; the rank programs are in
``tests/_torch_ssm_ranks.py``), at the smoke configs (8 SSM heads; zamba2
4 KV heads) on weights initialised by the JAX package.

  * Layer 0's Mamba2 block on meshes 2 and 4, f32 and bf16, ``none`` and
    ``w8a8``, cache-less, decode and prefill-commit (with ``n_valid``):
    the rank's ``in_z`` / ``in_x`` columns, the gated norm's input (the
    scan output plus the skip term) and the new ``ssm_h`` / conv tails are
    bitwise the unsharded port's slice of them; the block's output is
    within ``ssm.NORM_MESH_REL`` (1e-5 of its largest |value| in f32, 2^-6
    in bf16: the norm's sum over the mesh is another summation order).
  * ``prefill`` → ``greedy_decode`` of both models on meshes 2 and 4
    (f32, ``none`` and ``w8a8``) gives the JAX package's single-device
    tokens; the first logits within 1e-5 (``none``) or
    ``test_torch_model.TOL`` (``w8a8``) of the JAX engine's, the largest
    error relative to the largest |logit|.  A Scheduler trace on mesh 2
    gives the JAX Scheduler's tokens.
  * A ZeRO-1 train step of both smoke configs on (data 2, model 2)
    against the JAX package's single-device step, at the limits of
    ``tests/test_torch_sharded_training.py``: f32 (the classic layout) the
    loss and ``grad_norm`` within 1e-5 relative, every updated parameter
    within 1e-4, and every reduced gradient slice within 1e-4 relative
    norm of the JAX package's gradient (the ``partial`` tensors, summed
    over ``model``, among them); bf16 ZeRO-1 the loss within 1e-3 of the
    JAX package's bf16 loss, every reduced gradient slice within 2e-2
    relative norm of the port's single-device bf16 step, and the update
    through the optimizer alone bitwise.  A ``partial`` tensor's bf16
    gradient is the sum of the ranks' bf16 shares, each rounded before the
    sum where one device rounds the whole once, which parts from the
    single-device bf16 gradient past 2e-2 where the shares cancel
    (``conv_C``, ``A_log``, ``D``); it is held to the f32 gradient
    instead: no farther from it than the single-device bf16 gradient is,
    plus 2e-2.
  * SSM heads that do not divide the ``model`` extent raise, in
    ``shard_model``, ``init_cache`` and ``apply_mamba2``; a hybrid cache
    whose KV heads do not divide it splits its shared KV by sequence.

Each spawning test passes its ranks a timeout of at most 120 s.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize_params import quantize_model_params as jax_quantize
from repro.data.pipeline import SyntheticLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.training.train_step import TrainState as JaxState
from repro.training.train_step import make_loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.bridge import params_from_numpy, shard_model
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.launch.sharding import take_shard
from repro_torch.models import ssm
from repro_torch.optim.adamw import AdamW
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             trainable)
from test_torch_bridge import numpy_tree, paired_models, rel_err
from test_torch_model import TOL
from test_torch_moe import _cross_family_trace, _drive

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_ssm_ranks as ranks  # noqa: E402

SSM_ARCHS = ["mamba2_370m", "zamba2_7b"]
RANK_TIMEOUT = 120
DTYPES = ("float32", "bfloat16")
QUANTS = ("none", "w8a8")
LOGIT_TOL = {"none": 1e-5, "w8a8": TOL["w8a8"]}


@functools.lru_cache(maxsize=None)
def _models(arch, quant):
    """(jax cfg, jax params, torch cfg, numpy tree), f32, cached: the
    ``w8a8`` weights are the JAX package's quantization of the ``none``
    ones (``paired_models``' rule)."""
    if quant == "none":
        jcfg, params, tcfg, _ = paired_models(arch, dtype="float32")
    else:
        jcfg, params, tcfg, _ = _models(arch, "none")
        jcfg, tcfg = (c.replace(quant_proj=quant) for c in (jcfg, tcfg))
        params = jax_quantize(params)
    return jcfg, params, tcfg, numpy_tree(params)


# ---------------------------------------------------------------------------
# the Mamba2 block on a rank's heads
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _spawn(world):
    """One spawn of ``world`` ranks: the block cases, then the serves."""
    blocks, serves = {}, {}
    for arch in SSM_ARCHS:
        for quant in QUANTS:
            _, _, tcfg, tree = _models(arch, quant)
            for dtype in DTYPES:
                blocks[(arch, quant, dtype)] = (tree, tcfg, dtype, 3, 1)
            sched = (_sched_args(tcfg.vocab_size)
                     if world == 2 and quant == "none" else None)
            serves[(arch, quant)] = (tree, tcfg, _prompts(tcfg.vocab_size),
                                     STEPS, sched)
    return spawn_ranks(ranks.ssm_mesh_rank, world, backend="gloo",
                       device="cpu", args=(blocks, serves),
                       timeout=RANK_TIMEOUT)


def _blocks(world):
    return [run["blocks"] for run in _spawn(world)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_block_on_a_mesh_is_the_unsharded_slice(world, arch, quant, dtype):
    heads = _models(arch, quant)[2].ssm_n_heads
    limit = ssm.NORM_MESH_REL[ranks.DTYPES[dtype]]
    for r, run in enumerate(_blocks(world)):
        for mode in ranks.MODES:
            rec = run[((arch, quant, dtype), mode)]
            per = heads // world
            assert rec["heads"] == (r * per, (r + 1) * per)
            for name in ("z", "x", "y"):
                assert torch.equal(rec[f"got_{name}"], rec[f"ref_{name}"]), \
                    (r, mode, name)
            states = [k[10:] for k in rec if k.startswith("got_state_")]
            assert sorted(states) == ([] if mode == "cacheless" else
                                      ["conv_B", "conv_C", "conv_x", "h"])
            for name in states:
                assert torch.equal(rec[f"got_state_{name}"],
                                   rec[f"ref_state_{name}"]), \
                    (r, mode, name)
            assert rel_err(rec["got_out"], rec["ref_out"]) <= limit, \
                (r, mode)


# ---------------------------------------------------------------------------
# serving through the entry points against the JAX package
# ---------------------------------------------------------------------------
PROMPT_LENS = (7, 13, 4)
STEPS = 5
SCHED_KW = dict(slots=2, max_len=64, bucket=8, dtype=torch.float32)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, quant):
    """The JAX engine's first logits and greedy tokens, and (``none``) the
    JAX Scheduler's tokens on the cross-family trace."""
    jcfg, params, _, _ = _models(arch, quant)
    prompts = _prompts(jcfg.vocab_size)
    lens = np.array(PROMPT_LENS, np.int32)
    padded = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    cache = jax_init_cache(jcfg, len(prompts), max_len=int(lens.max())
                           + STEPS + 4, dtype=jnp.float32)
    logits, cache = jax_prefill(params, cache, jnp.asarray(padded),
                                jnp.asarray(lens), jcfg)
    first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, _ = jax_greedy_decode(params, cache, first, None, STEPS, jcfg)
    sched = None
    if quant == "none":
        trace, budgets = _cross_family_trace(jcfg.vocab_size)
        rids, out = _drive(JaxScheduler(params, jcfg, slots=2, max_len=64,
                                        bucket=8, dtype=jnp.float32),
                           trace, budgets)
        sched = [out[r] for r in rids]
    return np.asarray(logits), np.asarray(toks), sched


def _sched_args(vocab):
    """The cross-family trace, submitted at once (the JAX Scheduler's tokens
    do not depend on arrival: each request's are its isolated greedy
    tokens, ``tests/test_torch_ssm.py``)."""
    trace, budgets = _cross_family_trace(vocab)
    return trace, budgets, {k: v for k, v in SCHED_KW.items()}


def _serve(world, arch, quant):
    return [run["serve"][(arch, quant)] for run in _spawn(world)]


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_greedy_serve_on_a_mesh_gives_the_jax_tokens(world, arch, quant):
    jlogits, jtoks, _ = _jax_serve(arch, quant)
    tcfg = _models(arch, quant)[2]
    k, p = tcfg.ssm_conv - 1, tcfg.ssm_head_dim
    h = tcfg.ssm_n_heads // world
    b = len(PROMPT_LENS)
    runs = _serve(world, arch, quant)
    for r, run in enumerate(runs):
        assert run["kv_shard"] == "heads"
        shapes = run["shapes"]
        assert shapes["ssm_h"] == (tcfg.n_layers, b, h, p, tcfg.ssm_state)
        assert shapes["conv_x"] == (tcfg.n_layers, b, k, h * p)
        assert shapes["conv_B"] == (tcfg.n_layers, b, k, tcfg.ssm_state)
        if arch == "zamba2_7b":
            assert shapes["shared_k"][3] == tcfg.n_kv_heads // world
        np.testing.assert_array_equal(run["tokens"].numpy(), jtoks)
        assert rel_err(run["logits"], jlogits) <= LOGIT_TOL[quant], r
        # every rank holds the same bits of the replicated results
        assert torch.equal(run["logits"], runs[0]["logits"])
        assert run["seq_lens"].tolist() == [n + STEPS for n in PROMPT_LENS]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_scheduler_on_mesh_2_gives_the_jax_schedulers_tokens(arch):
    _, _, jsched = _jax_serve(arch, "none")
    for run in _serve(2, arch, "none"):
        assert len(run["sched"]) == len(jsched)
        for got, want in zip(run["sched"], jsched):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ZeRO-1 training on (data 2, model 2)
# ---------------------------------------------------------------------------
BATCH, SEQ, LR = 4, 32, 1e-3
TOL_LOSS = TOL_GNORM = 1e-5
TOL_PARAM = 1e-4
TOL_GRAD = 1e-4
BF16_LOSS, BF16_GRAD = 1e-3, 2e-2
# module 6's tensors, replicated over ``model``, whose gradient on a rank
# is its share (summed over ``model`` by the train step)
PARTIAL = ("in_B.w", "in_C.w", "in_dt.w", "conv_B.w", "conv_C.w",
           "ssm.A_log", "ssm.D", "ssm.dt_bias", "norm.w")


def _rank_mesh(g):
    d, m = divmod(g, 2)
    return Mesh(2, m, data=2, data_rank=d, device="cpu",
                axis_names=("data", "model"))


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _batch(vocab):
    return JaxLM(vocab, BATCH, SEQ, seed=0).batch_at(0)


@functools.lru_cache(maxsize=None)
def _train_spawn():
    """Both configs' sharded steps in one spawn of (data 2, model 2)."""
    cases = {}
    for arch in SSM_ARCHS:
        _, _, tcfg, tree = _models(arch, "none")
        cases[arch] = (tree, tcfg, _batch(tcfg.vocab_size))
    return spawn_ranks(ranks.ssm_train_rank, 4, data=2, backend="gloo",
                       device="cpu", args=(cases, LR), timeout=RANK_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _train(arch):
    """The JAX package's single-device f32 step, its f32 gradients and its
    bf16 loss; the port's single-device bf16 ZeRO-1 gradients; the port's
    (data 2, model 2) runs."""
    jcfg, params, tcfg, tree = _models(arch, "none")
    batch = _batch(jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = JaxAdamW(learning_rate=LR)
    jstate, jm = jax.jit(jax_train_step(jcfg, jopt))(
        JaxState.create(params, jopt), jb)
    after = trainable(params_from_numpy(numpy_tree(jstate.params), tcfg,
                                        device="cpu"))
    _, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg),
                                           has_aux=True))(params, jb)
    grads = trainable(params_from_numpy(numpy_tree(jgrads), tcfg,
                                        device="cpu"))
    bl, _ = jax.jit(jax_loss_fn(jcfg.replace(dtype="bfloat16")))(params, jb)
    opt = AdamW(learning_rate=LR, clip_norm=None)
    bgrads = {}
    update = opt.update

    def recorded(g, st, p, **kw):
        bgrads.update({n: x.float().clone() for n, x in g.items()})
        return update(g, st, p, **kw)

    object.__setattr__(opt, "update", recorded)
    tb = tcfg.replace(dtype="bfloat16")
    make_train_step(tb, opt)(
        TrainState.create(params_from_numpy(tree, tb, device="cpu"), opt,
                          zero1=True),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    runs = [run[arch] for run in _train_spawn()]
    return {"metrics": {k: float(v) for k, v in jm.items()}, "after": after,
            "grads": grads, "bf16_loss": float(bl), "bf16_grads": bgrads,
            "runs": runs, "cfg": tcfg}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_f32_step_on_2x2_matches_the_jax_single_device_step(arch):
    t = _train(arch)
    n_layers = t["cfg"].n_layers
    want_partial = {f"layers.{i}.mamba.{n}" for i in range(n_layers)
                    for n in PARTIAL}
    for g, run in enumerate(t["runs"]):
        assert want_partial <= set(run["partial"])
        assert not any(".mamba.in_x." in n or ".mamba.out_proj." in n
                       for n in run["partial"])
        m = run["metrics"]
        assert abs(m["loss"] - t["metrics"]["loss"]) \
            <= TOL_LOSS * abs(t["metrics"]["loss"]), g
        assert abs(m["grad_norm"] - t["metrics"]["grad_norm"]) \
            <= TOL_GNORM * t["metrics"]["grad_norm"], g
        mesh = _rank_mesh(g)
        assert set(run["grads"]) == set(t["grads"])
        for name, got in run["grads"].items():
            want = take_shard(t["grads"][name].float(), run["compute"][name],
                              mesh)
            assert got.shape == want.shape, name
            assert _rel_norm(got, want) <= TOL_GRAD, (g, name)
        for name, got in run["params"].items():
            want = take_shard(t["after"][name].float(), run["compute"][name],
                              mesh)
            assert float((got - want).abs().max()) <= TOL_PARAM, (g, name)
    # the split really happened: in_x's columns and out_proj's rows
    spec = t["runs"][0]["compute"]
    assert spec["layers.0.mamba.in_x.w"] == (None, "model")
    assert spec["layers.0.mamba.out_proj.w"] == ("model", None)
    assert spec["layers.0.mamba.conv_x.w"] == (None, "model")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_zero1_step_on_2x2_matches_the_jax_single_device_step(arch):
    t = _train(arch)
    for g, run in enumerate(t["runs"]):
        b = run["bf16"]
        assert abs(b["metrics"]["loss"] - t["bf16_loss"]) \
            <= BF16_LOSS * abs(t["bf16_loss"])
        mesh = _rank_mesh(g)
        fsdp = run["fsdp"]
        assert set(b["grads"]) == set(t["bf16_grads"])
        for name, got in b["grads"].items():
            want = take_shard(t["bf16_grads"][name], fsdp[name], mesh)
            assert got.shape == want.shape, name
            if name not in run["partial"]:
                assert _rel_norm(got, want) <= BF16_GRAD, (g, name)
                continue
            # each rank's bf16 share is rounded before the sum over model:
            # no farther from the f32 gradient than one device's bf16
            # gradient, give or take the bf16 limit
            f32 = take_shard(t["grads"][name].float(), fsdp[name], mesh)
            assert _rel_norm(got, f32) <= _rel_norm(want, f32) + BF16_GRAD, \
                (g, name)
        # the update through the optimizer alone, bitwise
        opt = AdamW(learning_rate=LR, clip_norm=None)
        p = {n: b["master0"][n].clone() for n in b["grads"]}
        opt.update({n: x.clone() for n, x in b["grads"].items()},
                   opt.init(p), p)
        for name, x in p.items():
            assert torch.equal(x, b["master"][name]), (g, name)


# ---------------------------------------------------------------------------
# in-process: the slices, and what raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_shard_model_slices_the_mamba_block(arch):
    """int8 in_z / in_x / out_proj are quantized whole, then sliced with
    their scales; in_B, conv_B, A_log and the norm stay whole."""
    _, _, tcfg, tree = _models(arch, "w8a8")
    whole = params_from_numpy(tree, tcfg, device="cpu").layers[0].mamba
    di = tcfg.d_inner
    for r in range(4):
        block = shard_model(params_from_numpy(tree, tcfg, device="cpu"),
                            Mesh(4, r, device="cpu")).layers[0].mamba
        cols = slice(r * di // 4, (r + 1) * di // 4)
        assert block.mesh.rank == r
        for name in ("in_z", "in_x"):
            lin, ref = getattr(block, name), getattr(whole, name)
            assert lin.shard == "column"
            assert torch.equal(lin.w_q_values, ref.w_q_values[:, cols])
            assert torch.equal(lin.w_q_scale, ref.w_q_scale[:, cols])
        assert block.out_proj.shard == "row"
        assert torch.equal(block.out_proj.w_q_values,
                           whole.out_proj.w_q_values[cols])
        assert torch.equal(block.out_proj.w_q_scale,
                           whole.out_proj.w_q_scale)
        assert torch.equal(block.conv_x.w, whole.conv_x.w[:, cols])
        for name in ("in_B", "in_C", "in_dt"):
            assert getattr(block, name).shard is None
        assert torch.equal(block.conv_B.w, whole.conv_B.w)
        assert torch.equal(block.ssm.A_log, whole.ssm.A_log)
        assert torch.equal(block.norm.w, whole.norm.w)


class _FakeMesh:
    """Duck-typed mesh (axis extents only)."""

    def __init__(self, model):
        self.shape = {"model": model}
        self.size = model


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_heads_that_do_not_divide_the_mesh_raise(arch):
    _, _, tcfg, tree = _models(arch, "none")
    assert tcfg.ssm_n_heads % 3
    with pytest.raises(ValueError, match="SSM heads"):
        shard_model(params_from_numpy(tree, tcfg, device="cpu"),
                    Mesh(3, 0, device="cpu"))
    with pytest.raises(ValueError, match="SSM heads"):
        init_cache(tcfg, 2, 16, torch.float32,
                   CacheConfig(mesh=_FakeMesh(3)), device="cpu")
    block = params_from_numpy(tree, tcfg, device="cpu").layers[0].mamba
    block.mesh = Mesh(3, 0, device="cpu")
    with pytest.raises(ValueError, match="SSM heads"):
        ssm.apply_mamba2(block, torch.zeros(1, 1, tcfg.d_model), tcfg)


def test_hybrid_cache_split_by_sequence_raises():
    """8 ranks: the 8 SSM heads split, the 4 KV heads of the shared block
    do not, so its dense KV splits by sequence (served in
    tests/test_torch_encdec_mesh.py): 2 of the 16 positions a rank."""
    tcfg = _models("zamba2_7b", "none")[2]
    assert tcfg.ssm_n_heads % 8 == 0 and tcfg.n_kv_heads % 8
    cache = init_cache(tcfg, 2, 16, torch.float32,
                       CacheConfig(mesh=_FakeMesh(8)), device="cpu")
    assert cache["kv_shard"] == "pages"
    sites = cache["shared_k"].shape[0]
    for key in ("shared_k", "shared_v"):
        assert tuple(cache[key].shape) == (sites, 2, 2, tcfg.n_kv_heads,
                                           tcfg.head_dim)
    assert cache["ssm_h"].shape[2] == tcfg.ssm_n_heads // 8
