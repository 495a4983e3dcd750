"""The encoder-decoder (seamless-m4t) and vision (phi-3-vision) families
under a mesh, and a dense cache split by sequence, on the CPU over gloo
ranks (``launch.mesh.spawn_ranks``; the rank programs are in
``tests/_torch_encdec_ranks.py``), at the smoke configs on weights
initialised by the JAX package, f32 ``none`` unless noted.

  * seamless on meshes 2 and 4 (4 heads, 4 KV heads): the memory of 80
    frames (past the smoke threshold of 64, so each rank's encoder heads
    attend through K5's plain version, non-causal) within 1e-5 of the JAX
    package's single-device ``encode``, and ``prefill`` → ``greedy_decode``
    with ``memory=`` on a paged cache of the mesh gives the JAX engine's
    tokens, the first logits within 1e-5.  Under ``w8a8`` the memory and
    layer 1's cross-attention output are bitwise mesh 1's (the column
    splits compute whole columns, the row-parallel ``wo`` and ``down`` sum
    int32 partials exactly); under ``none`` the row-parallel sums are in
    rank order, so the cross-attention output is held within 1e-6 of its
    largest |value|.
  * A ZeRO-1 step of seamless on (data 2, model 2) against the JAX
    package's single-device step, at the limits of
    ``tests/test_torch_sharded_training.py``: f32 loss and ``grad_norm``
    within 1e-5 relative, each reduced gradient slice within 1e-4 relative
    norm, each updated parameter within 1e-4; the bf16 ZeRO-1 loss within
    1e-3 of the JAX package's bf16 loss and each gradient slice within
    2e-2 relative norm of the port's single-device bf16 step.
  * phi3's ``prefill_step(frontend_embeds=)`` on meshes 2 and 4: logits
    within 1e-5 of the JAX package's.
  * A dense cache split by sequence: qwen2.5-3b's smoke config (2 KV heads)
    on mesh 4 gives the JAX engine's greedy tokens (first logits within
    1e-5), each rank holding a quarter of the positions; a zamba2 smoke
    variant whose shared block has 2 KV heads gives, on mesh 4, its mesh 1
    tokens, the shared KV split by sequence.

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

from repro.data.pipeline import SyntheticLM as JaxLM
from repro.models.attention import apply_attention as jax_attention
from repro.models.transformer import encode as jax_encode
from repro.optim.adamw import AdamW as JaxAdamW
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro.serving.engine import prefill_step as jax_prefill_step
from repro.training.train_step import TrainState as JaxState
from repro.training.train_step import make_loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, PlacementMesh, spawn_ranks
from repro_torch.launch.sharding import (make_param_rules, param_specs,
                                         take_shard)
from repro_torch.optim.adamw import AdamW
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             trainable)
from test_torch_bridge import numpy_tree, paired_models, rel_err

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_encdec_ranks as ranks  # noqa: E402
import _torch_ssm_ranks as ssm_ranks  # noqa: E402

RANK_TIMEOUT = 120
ENC, VLM, DENSE, HYBRID = ("seamless_m4t_medium", "phi3_vision_4_2b",
                           "qwen2_5_3b", "zamba2_7b")
PROMPT_LENS = (7, 13, 4)
STEPS = 5
FRAMES = 80
PAGED = dict(layout="paged", page_size=8, alloc="striped")


@functools.lru_cache(maxsize=None)
def _models(arch, quant="none", **overrides):
    """(jax cfg, jax params, torch cfg, numpy tree), f32, cached."""
    jcfg, params, tcfg, _ = paired_models(arch, quant_proj=quant,
                                          dtype="float32", **overrides)
    return jcfg, params, tcfg, numpy_tree(params)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _padded(prompts):
    lens = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    return padded, lens


def _enc_inputs(d_model):
    return (_normal((len(PROMPT_LENS), FRAMES, d_model), 8),
            _normal((len(PROMPT_LENS), 7, d_model), 9))


def _vlm_inputs(cfg):
    tokens = np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 9))
    return tokens.astype(np.int32), _normal((2, cfg.frontend_len,
                                             cfg.d_model), 4)


@functools.lru_cache(maxsize=None)
def _spawn(world):
    """One spawn of ``world`` ranks running every serving program."""
    progs = {}
    for quant in ("none", "w8a8"):
        _, _, tcfg, tree = _models(ENC, quant)
        frames, x = _enc_inputs(tcfg.d_model)
        progs[("enc", quant)] = ("encdec_rank", (
            tree, tcfg, torch.from_numpy(frames), torch.from_numpy(x),
            _prompts(tcfg.vocab_size), STEPS, PAGED))
    _, _, vcfg, vtree = _models(VLM)
    tokens, patches = _vlm_inputs(vcfg)
    progs["vlm"] = ("vlm_rank", (vtree, vcfg, torch.from_numpy(tokens),
                                 torch.from_numpy(patches)))
    if world == 4:
        _, _, qcfg, qtree = _models(DENSE)
        progs["dense"] = ("seq_split_rank", (qtree, qcfg,
                                             _prompts(qcfg.vocab_size),
                                             STEPS))
        _, _, zcfg, ztree = _models(HYBRID, n_kv_heads=2)
        progs["hybrid"] = ("seq_split_rank", (ztree, zcfg,
                                              _prompts(zcfg.vocab_size),
                                              STEPS, True))
    return spawn_ranks(ranks.mesh_programs, world, backend="gloo",
                       device="cpu", args=(progs,), timeout=RANK_TIMEOUT)


# ---------------------------------------------------------------------------
# seamless: the encoder, cross-attention and the serve with memory=
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_encdec():
    """The JAX package's memory, layer 1's cross-attention of ``x`` to it,
    and the paged engine's first logits and greedy tokens."""
    jcfg, params, _, _ = _models(ENC)
    frames, x = _enc_inputs(jcfg.d_model)
    mem = jax_encode(params, jnp.asarray(frames), jcfg)
    cross, _ = jax_attention(jax.tree.map(lambda a: a[1],
                                          params["layers"]["cross"]),
                             jnp.asarray(x), jcfg,
                             positions=jnp.arange(x.shape[1]), memory=mem)
    padded, lens = _padded(_prompts(jcfg.vocab_size))
    cache = jax_init_cache(jcfg, len(lens), int(lens.max()) + STEPS + 4,
                           dtype=jnp.float32, config=JaxCacheConfig(**PAGED))
    logits, cache = jax_prefill(params, cache, jnp.asarray(padded),
                                jnp.asarray(lens), jcfg, memory=mem)
    first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, _ = jax_greedy_decode(params, cache, first, None, STEPS, jcfg,
                                memory=mem)
    return (np.asarray(mem), np.asarray(cross), np.asarray(logits),
            np.asarray(toks))


@pytest.mark.parametrize("world", [2, 4])
def test_seamless_on_a_mesh_gives_the_jax_memory_and_tokens(world):
    jmem, jcross, jlogits, jtoks = _jax_encdec()
    tcfg = _models(ENC)[2]
    runs = [run[("enc", "none")] for run in _spawn(world)]
    for r, run in enumerate(runs):
        assert run["wq_cols"] == (tcfg.d_model, tcfg.q_dim // world)
        assert run["enc_wo"] == "row"
        assert rel_err(run["got_memory"], jmem) <= 1e-5, r
        assert rel_err(run["got_cross"], jcross) <= 1e-5, r
        serve = run["serve"]
        assert serve["kv_shard"] == "heads"
        assert serve["shapes"]["k_pages"][3] == tcfg.n_kv_heads // world
        np.testing.assert_array_equal(serve["tokens"].numpy(), jtoks)
        assert rel_err(serve["logits"], jlogits) <= 1e-5, r
        # every rank holds the same bits of the replicated results
        assert torch.equal(run["got_memory"], runs[0]["got_memory"])
        assert torch.equal(serve["logits"], runs[0]["serve"]["logits"])


@pytest.mark.parametrize("quant", ["none", "w8a8"])
@pytest.mark.parametrize("world", [2, 4])
def test_cross_attention_on_a_mesh_is_mesh_1s(world, quant):
    for r, run in enumerate(_spawn(world)):
        run = run[("enc", quant)]
        if quant == "w8a8":
            assert torch.equal(run["got_memory"], run["ref_memory"]), r
            assert torch.equal(run["got_cross"], run["ref_cross"]), r
        else:
            assert rel_err(run["got_memory"], run["ref_memory"]) <= 1e-5
            assert rel_err(run["got_cross"], run["ref_cross"]) <= 1e-6, r


def test_seamless_vocabulary_stays_whole_on_4_ranks():
    """256,206 rows do not divide 4: shard-if-divisible leaves the
    embedding and the head whole, while every encoder and cross projection
    splits."""
    cfg = get_config(ENC).replace(quant_proj="w8a8", dtype="bfloat16")
    shapes = {n: s for n, (s, _) in dryrun.params_shape_for(
        cfg, quantized=True).items()}
    specs = param_specs(shapes, PlacementMesh(model=4), make_param_rules())
    assert specs["embed.table"] == (None, None)
    assert specs.get("lm_head.w", (None, None)) == (None, None)
    for name in ("encoder.layers.0.attn.wq.w_q_values",
                 "layers.0.cross.wk.w_q_values",
                 "encoder.layers.11.ffn.up.w_q_values"):
        assert specs[name] == (None, "model"), name
    for name in ("layers.0.cross.wo.w_q_values",
                 "encoder.layers.11.ffn.down.w_q_values"):
        assert specs[name] == ("model", None), name


# ---------------------------------------------------------------------------
# seamless: a ZeRO-1 step on (data 2, model 2)
# ---------------------------------------------------------------------------
BATCH, SEQ, LR = 4, 32, 1e-3


def _batch(cfg):
    return JaxLM(cfg.vocab_size, BATCH, SEQ, seed=0, frontend=cfg.frontend,
                 frontend_len=cfg.frontend_len,
                 d_model=cfg.d_model).batch_at(0)


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _rank_mesh(g):
    d, m = divmod(g, 2)
    return Mesh(2, m, data=2, data_rank=d, device="cpu",
                axis_names=("data", "model"))


@functools.lru_cache(maxsize=None)
def _train():
    """The JAX package's single-device f32 step, gradients and bf16 loss;
    the port's single-device bf16 ZeRO-1 gradients; the (2, 2) runs."""
    jcfg, params, tcfg, tree = _models(ENC)
    batch = _batch(jcfg)
    assert "encoder_frames" in batch
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
    runs = spawn_ranks(ssm_ranks.train_case_rank, 4, data=2, backend="gloo",
                       device="cpu", args=(tree, tcfg, batch, LR),
                       timeout=RANK_TIMEOUT)
    return {"metrics": {k: float(v) for k, v in jm.items()}, "after": after,
            "grads": grads, "bf16_loss": float(bl), "bf16_grads": bgrads,
            "runs": runs}


def test_seamless_f32_step_on_2x2_matches_the_jax_single_device_step():
    t = _train()
    for g, run in enumerate(t["runs"]):
        m = run["metrics"]
        assert abs(m["loss"] - t["metrics"]["loss"]) \
            <= 1e-5 * abs(t["metrics"]["loss"]), g
        assert abs(m["grad_norm"] - t["metrics"]["grad_norm"]) \
            <= 1e-5 * t["metrics"]["grad_norm"], g
        mesh = _rank_mesh(g)
        assert set(run["grads"]) == set(t["grads"])
        for name, got in run["grads"].items():
            want = take_shard(t["grads"][name].float(), run["compute"][name],
                              mesh)
            assert got.shape == want.shape, name
            assert _rel_norm(got, want) <= 1e-4, (g, name)
        for name, got in run["params"].items():
            want = take_shard(t["after"][name].float(), run["compute"][name],
                              mesh)
            assert float((got - want).abs().max()) <= 1e-4, (g, name)
    # the encoder and the cross projections really split over model
    spec = t["runs"][0]["compute"]
    assert spec["encoder.layers.0.attn.wq.w"] == (None, "model")
    assert spec["layers.0.cross.wk.w"] == (None, "model")
    assert spec["layers.0.cross.wo.w"] == ("model", None)


def test_seamless_zero1_step_on_2x2_matches_the_single_device_step():
    t = _train()
    for g, run in enumerate(t["runs"]):
        b = run["bf16"]
        assert abs(b["metrics"]["loss"] - t["bf16_loss"]) \
            <= 1e-3 * abs(t["bf16_loss"])
        mesh = _rank_mesh(g)
        assert set(b["grads"]) == set(t["bf16_grads"])
        for name, got in b["grads"].items():
            want = take_shard(t["bf16_grads"][name], run["fsdp"][name], mesh)
            assert got.shape == want.shape, name
            assert _rel_norm(got, want) <= 2e-2, (g, name)


# ---------------------------------------------------------------------------
# phi3: the spliced patches
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_vlm():
    jcfg, params, _, _ = _models(VLM)
    tokens, patches = _vlm_inputs(jcfg)
    logits, _ = jax_prefill_step(params, jnp.asarray(tokens), jcfg,
                                 frontend_embeds=jnp.asarray(patches))
    return np.asarray(logits)


@pytest.mark.parametrize("world", [2, 4])
def test_phi3_prefill_step_on_a_mesh_matches_jax(world):
    want = _jax_vlm()
    runs = [run["vlm"] for run in _spawn(world)]
    for r, got in enumerate(runs):
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-5, r
        assert torch.equal(got, runs[0])


# ---------------------------------------------------------------------------
# the dense cache split by sequence
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_dense_serve():
    jcfg, params, _, _ = _models(DENSE)
    padded, lens = _padded(_prompts(jcfg.vocab_size))
    cache = jax_init_cache(jcfg, len(lens), int(lens.max()) + STEPS + 4,
                           dtype=jnp.float32)
    logits, cache = jax_prefill(params, cache, jnp.asarray(padded),
                                jnp.asarray(lens), jcfg)
    first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, _ = jax_greedy_decode(params, cache, first, jnp.asarray(lens),
                                STEPS, jcfg)
    return np.asarray(logits), np.asarray(toks)


def test_dense_cache_split_by_sequence_gives_the_jax_tokens():
    jlogits, jtoks = _jax_dense_serve()
    tcfg = _models(DENSE)[2]
    assert tcfg.n_kv_heads % 4
    # max_len 22 rounds up to 24: 6 positions a rank
    want = (tcfg.n_layers, len(PROMPT_LENS), 6, tcfg.n_kv_heads,
            tcfg.head_dim)
    for r, run in enumerate(_spawn(4)):
        run = run["dense"]
        assert run["kv_shard"] == "pages"
        assert run["shapes"]["k"] == want
        np.testing.assert_array_equal(run["tokens"].numpy(), jtoks)
        assert rel_err(run["logits"], jlogits) <= 1e-5, r


def test_hybrid_shared_kv_split_by_sequence_gives_mesh_1_tokens():
    tcfg = _models(HYBRID, n_kv_heads=2)[2]
    assert tcfg.ssm_n_heads % 4 == 0 and tcfg.n_kv_heads % 4
    for r, run in enumerate(_spawn(4)):
        run = run["hybrid"]
        assert run["kv_shard"] == "pages"
        assert run["shapes"]["shared_k"][2:] == (6, 2, tcfg.head_dim)
        assert run["shapes"]["ssm_h"][2] == tcfg.ssm_n_heads // 4
        assert torch.equal(run["tokens"], run["mesh1"]["tokens"]), r
        assert rel_err(run["logits"], run["mesh1"]["logits"]) <= 1e-5, r
