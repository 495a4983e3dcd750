"""Port's MoE family vs the JAX package, f32, smoke configs, on weights
initialised by the JAX package and carried over through numpy: capacity,
routing (ties included), dispatch with dropped copies, the combine, the
load-balance loss, expert quantization, the whole model, decode, the paged
serve, the Scheduler and speculative decode.  Mirrors
``tests/test_models.py``, ``tests/test_decode.py`` and the MoE cases of
``tests/test_serving.py``.

Tolerances: rel-err (max |port - jax| / max |jax|) 1e-5 for the MoE block
in f32 (the two frameworks' matmuls and softmax differ in the last bits),
1e-6 absolute for the load-balance loss (about 1: a mean of products of
f32 means); the whole model at ``test_torch_model.TOL``.
"""
import copy
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize_params import quantize_model_params as jax_quantize
from repro.models import moe as jax_moe
from repro.models.transformer import apply_model as jax_apply_model
from repro.models.transformer import init_model as jax_init_model
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.scheduler import SpecConfig as JaxSpecConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantization import QTensor
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Model, apply_model, init_model)
from repro_torch.serving import allocator as al
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import greedy_decode, prefill, serve_step
from repro_torch.serving.scheduler import Scheduler, SpecConfig
from repro_torch.serving.state import (HybridHandler, PagedKVHandler,
                                       SlotStateHandler, state_handler)
from test_torch_bridge import numpy_tree, paired_configs, rel_err
from test_torch_model import TOL
from test_torch_paged import LENS, PAGED, _prompts, jax_paged_serve, \
    port_serve

MOE_ARCHS = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"]
MOE_TOL = 1e-5
LB_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def moe_models(arch, *, seed=0, quantize_experts=True, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_model) with the same weights;
    under a quantizing ``quant_proj`` both hold the JAX package's int8
    projections and, with ``quantize_experts``, its int8 experts (the
    serving launcher's choice for the family).  Cached: callers must not
    change what they are given."""
    jcfg, tcfg = paired_configs(arch, **overrides)
    params = jax_init_model(jax.random.PRNGKey(seed),
                            jcfg.replace(quant_proj="none"))
    if jcfg.quant_proj != "none":
        params = jax_quantize(params, quantize_experts=quantize_experts)
    model = params_from_numpy(numpy_tree(params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def layer_params(params, i=0):
    return jax.tree.map(lambda a: a[i], params["layers"]["moe"])


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 5, 8, 12, 40, 64, 129, 8192])
def test_capacity_equals_jax(s):
    for e, k, cf in itertools.product((8, 40, 128), (1, 2, 8),
                                      (0.25, 1.0, 1.25, 8.0)):
        cfg = get_smoke_config("qwen3_moe_30b_a3b").replace(
            n_experts=e, top_k=k, capacity_factor=cf)
        jcfg = paired_configs("qwen3_moe_30b_a3b", n_experts=e, top_k=k,
                              capacity_factor=cf)[0]
        assert moe._capacity(cfg, s) == jax_moe._capacity(jcfg, s), \
            (s, e, k, cf)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------
VARIANTS = {
    "default": {},
    "drops": {"capacity_factor": 0.25},        # copies overflow and drop
    "no_renorm": {"router_norm_topk": False},
    "shared": {"n_shared_experts": 1},
}


def _block_pair(arch, variant, quant="none"):
    jcfg, params, tcfg, model = moe_models(arch, quant_proj=quant,
                                           dtype="float32",
                                           **VARIANTS[variant])
    return jcfg, layer_params(params), tcfg, model.layers[0].moe


def _x(b, s, d, seed=4):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("bs", [(2, 12), (1, 1), (3, 40)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_moe_matches_jax(arch, bs, variant):
    jcfg, jp, tcfg, block = _block_pair(arch, variant)
    x = _x(*bs, tcfg.d_model)
    y, aux = moe.apply_moe(block, torch.from_numpy(x), tcfg)
    yj, auxj = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert rel_err(y.numpy(), yj) <= MOE_TOL
    assert abs(float(aux["load_balance_loss"])
               - float(auxj["load_balance_loss"])) <= LB_TOL
    # routing is equal; a token whose every copy dropped is exactly 0 on
    # both sides
    _, idx, _ = moe.route(block.router, torch.from_numpy(x), tcfg)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x),
                                      jp["router"]["w"]), axis=-1)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jax.lax.top_k(probs,
                                                           jcfg.top_k)[1]))
    if variant != "shared":
        zero = (y.abs().amax(-1) == 0).numpy()
        np.testing.assert_array_equal(zero,
                                      np.asarray(jnp.abs(yj).max(-1) == 0))
        if variant == "drops" and bs == (3, 40):
            assert zero.any(), "no token lost every copy: the case is void"


def test_moe_drops_copies_past_capacity():
    """At capacity_factor 0.25 some copies drop, the later tokens of an
    overloaded expert first (the stable sort keeps token order)."""
    _, _, tcfg, block = _block_pair("qwen3_moe_30b_a3b", "drops")
    x = torch.from_numpy(_x(3, 40, tcfg.d_model))
    _, idx, _ = moe.route(block.router, x, tcfg)
    c = moe._capacity(tcfg, 40)
    per_expert = torch.stack([torch.bincount(r.reshape(-1),
                                             minlength=tcfg.n_experts)
                              for r in idx])
    assert int(per_expert.max()) > c


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    """Every probability ties: both packages route to experts 0..k-1."""
    jcfg, jp, tcfg, block = _block_pair(arch, "default")
    block = copy.deepcopy(block)
    block.router.w.zero_()
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    x = _x(2, 12, tcfg.d_model)
    gates, idx, aux = moe.route(block.router, torch.from_numpy(x), tcfg)
    want = np.broadcast_to(np.arange(tcfg.top_k), idx.shape)
    np.testing.assert_array_equal(idx.numpy(), want)
    probs = jax.nn.softmax(jnp.zeros((2, 12, jcfg.n_experts)), axis=-1)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1]), want)
    np.testing.assert_allclose(gates.numpy(), 1.0 / tcfg.top_k, rtol=1e-6)
    y, aux = moe.apply_moe(block, torch.from_numpy(x), tcfg)
    yj, auxj = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    assert rel_err(y.numpy(), yj) <= MOE_TOL
    assert abs(float(aux["load_balance_loss"])
               - float(auxj["load_balance_loss"])) <= LB_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_quantized_experts_match_jax(arch):
    """w8 experts: dequantized in the activation dtype, then the plain
    product, as the reference."""
    jcfg, jp, tcfg, block = _block_pair(arch, "default", quant="w8")
    assert isinstance(block.experts.weight("gate"), QTensor)
    x = _x(2, 12, tcfg.d_model)
    y, _ = moe.apply_moe(block, torch.from_numpy(x), tcfg)
    yj, _ = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    assert rel_err(y.numpy(), yj) <= MOE_TOL


def test_bf16_combine_is_deterministic():
    """The bf16 combine adds in a fixed order: two calls are bitwise
    equal, and they agree with the f32 block to bf16's precision."""
    _, _, tcfg, block = _block_pair("qwen3_moe_30b_a3b", "default")
    cfg = tcfg.replace(dtype="bfloat16")
    x = torch.from_numpy(_x(3, 40, cfg.d_model))
    y1, _ = moe.apply_moe(block, x.to(torch.bfloat16), cfg)
    y2, _ = moe.apply_moe(block, x.to(torch.bfloat16), cfg)
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2)
    y32, _ = moe.apply_moe(block, x, tcfg)
    assert rel_err(y1.float().numpy(), y32.numpy()) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_is_the_reference_formula(dtype):
    """``expert_weight``'s one-pass dequant is bitwise the reference's
    ``values.astype(dtype) * scale.astype(dtype)``."""
    _, _, _, block = _block_pair("qwen3_moe_30b_a3b", "default", quant="w8")
    for name in moe.Experts.NAMES:
        q = block.experts.weight(name)
        got = moe.expert_weight(block.experts, name, dtype)
        assert got.dtype == dtype
        assert torch.equal(got, q.values.to(dtype) * q.scale.to(dtype))


def test_sharded_moe_impl_raises():
    _, _, tcfg, block = _block_pair("qwen3_moe_30b_a3b", "default")
    with pytest.raises(NotImplementedError, match="item 13"):
        moe.apply_moe(block, torch.zeros(1, 2, tcfg.d_model),
                      tcfg.replace(moe_impl="sharded"))


# ---------------------------------------------------------------------------
# weights: bridge, init, quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_bridge_carries_every_moe_leaf(arch, quant):
    _, params, tcfg, model = moe_models(arch, quant_proj=quant,
                                        n_shared_experts=1)
    tree = numpy_tree(params)["layers"]["moe"]
    for i, layer in enumerate(model.layers):
        assert layer.ffn is None
        np.testing.assert_array_equal(layer.moe.router.w.numpy(),
                                      tree["router"]["w"][i])
        for name in ("gate", "up", "down"):
            w = layer.moe.experts.weight(name)
            if quant == "none":
                np.testing.assert_array_equal(w.numpy(),
                                              tree["experts"][name][i])
            else:
                q = tree["experts"][name + "_q"]
                np.testing.assert_array_equal(w.values.numpy(),
                                              q["values"][i])
                np.testing.assert_array_equal(w.scale.numpy(), q["scale"][i])
                assert w.values.is_contiguous()      # (E, K, N) as stored
        shared = layer.moe.shared
        node = tree["shared"]["up"]
        got = shared.up.w if quant == "none" else shared.up.w_q.values
        want = node["w"][i] if quant == "none" else node["w_q"]["values"][i]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_quantize_experts_bitwise_jax(arch):
    """Values and scales per (layer, expert, output channel) bitwise the
    JAX package's; routers stay float."""
    jcfg, params, tcfg, master = moe_models(arch, quant_proj="none")
    jq = numpy_tree(jax_quantize(params, quantize_experts=True))
    model = quantize_model_params(master, quantize_experts=True)
    for i, layer in enumerate(model.layers):
        for name in ("gate", "up", "down"):
            w = layer.moe.experts.weight(name)
            q = jq["layers"]["moe"]["experts"][name + "_q"]
            np.testing.assert_array_equal(w.values.numpy(), q["values"][i])
            np.testing.assert_array_equal(w.scale.numpy(), q["scale"][i])
            assert w.scale.shape == (tcfg.n_experts, 1,
                                     w.values.shape[-1])
        assert layer.moe.router.w is not None
        assert layer.attn.wq.w_q is not None
    # without the flag the experts stay float, as in the JAX walk
    plain = quantize_model_params(master)
    assert plain.layers[0].moe.experts.gate is not None
    assert "gate" in jax_quantize(params)["layers"]["moe"]["experts"]
    assert master.layers[0].moe.experts.gate is not None   # input untouched


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_model_quantizes_block_by_block(arch):
    """``each_block`` quantizes each block as it is drawn: the same model
    as quantizing the whole f32 model afterwards."""
    cfg = get_smoke_config(arch)

    def quantize(block):
        return quantize_model_params(block, quantize_experts=True)

    whole = quantize_model_params(
        init_model(torch.Generator().manual_seed(3), cfg, device="cpu"),
        quantize_experts=True)
    each = init_model(torch.Generator().manual_seed(3), cfg, device="cpu",
                      each_block=quantize)
    b1, b2 = dict(whole.named_buffers()), dict(each.named_buffers())
    assert b1.keys() == b2.keys()
    for name in b1:
        assert torch.equal(b1[name], b2[name]), name
    assert each.layers[0].moe.experts.gate_values.dtype == torch.int8


def test_check_supported_admits_moe_only():
    """The MoE configs get the paged handler, the SSM and hybrid configs
    their slot handlers; the vision and audio families build a model and a
    cache and get the paged handler, and the Scheduler refuses the audio
    (encoder-decoder) family."""
    from repro import configs as jax_configs
    for arch in MOE_ARCHS:
        cfg = get_smoke_config(arch)
        init_cache(cfg, 2, 8, device="cpu")
        assert isinstance(state_handler(cfg), PagedKVHandler)
    for arch, handler in (("mamba2_370m", SlotStateHandler),
                          ("zamba2_7b", HybridHandler)):
        cfg = get_smoke_config(arch)
        init_cache(cfg, 2, 8, device="cpu")
        assert type(state_handler(cfg)) is handler
    for arch in ("phi3_vision_4_2b", "seamless_m4t_medium"):
        cfg = ModelConfig(**dataclasses.asdict(
            jax_configs.get_smoke_config(arch)))
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        init_cache(cfg, 2, 8, device="cpu")
        assert isinstance(state_handler(cfg), PagedKVHandler)
        if cfg.is_encoder_decoder:
            with pytest.raises(NotImplementedError, match="memory="):
                Scheduler(model, cfg, slots=2, max_len=32, device="cpu")
        else:
            Scheduler(model, cfg, slots=2, max_len=32, device="cpu")


# ---------------------------------------------------------------------------
# the model, decode and serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_apply_model_matches_jax(arch, mode):
    jcfg, params, tcfg, model = moe_models(arch, quant_proj=mode,
                                           dtype="float32")
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    logits, cache, aux = apply_model(model, torch.from_numpy(toks), tcfg)
    ref, _, jaux = jax_apply_model(params, jnp.asarray(toks), jcfg)
    assert cache is None and logits.shape == (2, 24, jcfg.vocab_size)
    assert rel_err(logits.numpy(), ref) <= TOL[mode]
    # the load-balance loss summed over the layers
    lb = float(aux["load_balance_loss"])
    assert lb > 0 and abs(lb - float(jaux["load_balance_loss"])) <= \
        tcfg.n_layers * LB_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_full_forward_with_capacity_headroom(arch):
    """Token-by-token ``serve_step`` equals the full forward when no copy
    drops (capacity_factor 8), as ``tests/test_decode.py``'s MoE case."""
    cfg = get_smoke_config(arch).replace(quant_proj="none", dtype="float32",
                                         capacity_factor=8.0)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    b, s = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)))
    full, _, _ = apply_model(model, tokens, cfg)
    cache = init_cache(cfg, b, 16, torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = serve_step(model, cache, tokens[:, t:t + 1], t, cfg)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert rel_err(dec.numpy(), full.numpy()) < 5e-5


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["w8a8", "none"])
def test_paged_greedy_tokens_equal_jax_engine(arch, mode):
    jcfg, params, tcfg, model = moe_models(arch, quant_proj=mode,
                                           dtype="float32")
    prompts = _prompts(jcfg.vocab_size)
    want = jax_paged_serve(jcfg, params, prompts, **PAGED)
    _, toks, cache = port_serve(tcfg, model, prompts, CacheConfig(**PAGED))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert cache["seq_lens"].tolist() == (LENS + 4).tolist()


def _cross_family_trace(vocab):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12)]
    return prompts, [4, 6, 3, 5]


def _drive(sched, prompts, budgets):
    rids = [sched.submit(prompts[0], budgets[0]),
            sched.submit(prompts[1], budgets[1])]
    sched.step()                                  # arrivals mid-stream
    rids.append(sched.submit(prompts[2], budgets[2]))
    rids.append(sched.submit(prompts[3], budgets[3]))
    return rids, sched.run(max_ticks=200)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_scheduler_matches_isolated_and_jax(arch):
    """The MoE case of the JAX package's cross-family Scheduler test: per
    request, the Scheduler's tokens are the isolated prefill →
    greedy_decode tokens, and the JAX Scheduler's."""
    jcfg, params, tcfg, model = moe_models(arch, dtype="float32")
    prompts, budgets = _cross_family_trace(tcfg.vocab_size)
    rids, out = _drive(Scheduler(model, tcfg, slots=2, max_len=64, bucket=8,
                                 dtype=torch.float32, device="cpu"),
                       prompts, budgets)
    jrids, jout = _drive(JaxScheduler(params, jcfg, slots=2, max_len=64,
                                      bucket=8, dtype=jnp.float32),
                         prompts, budgets)
    config = CacheConfig(layout="paged", alloc="dynamic", page_size=16)
    for rid, jrid, p, m in zip(rids, jrids, prompts, budgets):
        cache = init_cache(tcfg, 1, 64, torch.float32, config, device="cpu")
        cache, ok = al.admit_sequence(cache, 0, p.size + m)
        assert bool(ok)
        padded = np.pad(p, (0, -p.size % 8))     # the scheduler's bucket
        nl, cache = prefill(model, cache, torch.from_numpy(padded[None]),
                            torch.tensor([p.size]), tcfg)
        first = torch.argmax(nl, -1)[:, None]
        toks, _ = greedy_decode(model, cache, first, None, m - 1, tcfg)
        np.testing.assert_array_equal(out[rid], toks[0].numpy())
        np.testing.assert_array_equal(out[rid], jout[jrid])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_self_trunc_tokens_equal_plain(arch):
    """Speculative decode with the target's first layer as the draft emits
    the plain Scheduler's tokens, and the JAX speculative Scheduler's."""
    jcfg, params, tcfg, model = moe_models(arch, dtype="float32")
    prompts, budgets = _cross_family_trace(tcfg.vocab_size)
    dcfg, jdcfg = tcfg.replace(n_layers=1), jcfg.replace(n_layers=1)
    draft = Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head)
    jtrunc = dict(params)
    jtrunc["layers"] = jax.tree.map(lambda x: x[:1], params["layers"])

    rids, plain = _drive(Scheduler(model, tcfg, slots=2, max_len=64,
                                   bucket=8, dtype=torch.float32,
                                   device="cpu"), prompts, budgets)
    sched = Scheduler(model, tcfg, slots=2, max_len=64, bucket=8,
                      dtype=torch.float32,
                      spec=SpecConfig(draft, dcfg, n_draft=3), device="cpu")
    srids, spec = _drive(sched, prompts, budgets)
    jsched = JaxScheduler(
        params, jcfg, slots=2, max_len=64, bucket=8, dtype=jnp.float32,
        spec=JaxSpecConfig(jtrunc, jdcfg, n_draft=3),
        config=JaxCacheConfig(layout="paged", alloc="dynamic",
                              page_size=16))
    jrids, jspec = _drive(jsched, prompts, budgets)
    for rid, srid, jrid in zip(rids, srids, jrids):
        np.testing.assert_array_equal(spec[srid], plain[rid])
        np.testing.assert_array_equal(spec[srid], jspec[jrid])
    # proposals and acceptances tick for tick as the reference's
    assert sched.spec_stats == jsched.spec_stats
