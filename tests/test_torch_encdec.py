"""Port's encoder-decoder family (seamless-m4t-medium's smoke config) vs the
JAX package, on weights initialised by the JAX package and carried over
through numpy: cross-attention, the bidirectional encoder below and above
the blockwise threshold, the whole model from frames or from precomputed
memory, decode on the dense and the paged cache, the serving engine with
``memory=``, ``prefill_step(encoder_frames=)``, the bridge, the weight
quantization walk, and every input the port refuses where the JAX package
would drop it.  Mirrors the seamless cases of ``tests/test_decode.py`` and
``tests/test_system.py``.

Tolerances: rel-err (max |port - jax| / max |jax|) 1e-5 in f32 where no
int8 rounding sits between the two (``none``, ``w8``), and
``test_torch_model.TOL`` under ``w8a8``; decode against the full forward
5e-5, the JAX package's own limit; tokens exactly.  Above the threshold the
JAX side attends through its plain blockwise path (the CPU's kernel mode
is ``ref``), the port through K5's plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models.transformer import apply_model as jax_apply_model
from repro.models.transformer import encode as jax_encode
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro.serving.engine import prefill_step as jax_prefill_step
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.models.attention import apply_attention
from repro_torch.models.transformer import (DecoderBlock, Encoder,
                                            apply_model, encode, init_model)
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import (greedy_decode, prefill, prefill_step,
                                        serve_step, spec_step)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.state import PagedKVHandler, state_handler
from test_torch_bridge import numpy_tree, paired_models, rel_err
from test_torch_model import TOL

ARCH = "seamless_m4t_medium"
PAGED = dict(layout="paged", page_size=8, alloc="striped")
LENS = np.array([12, 9, 5], np.int32)
FRAMES = 20                 # memory rows in the serving tests (T != S)
N_STEPS = 5


@functools.lru_cache(maxsize=None)
def encdec_models(mode="none"):
    """``paired_models`` in f32, cached: callers must not change what they
    are given."""
    return paired_models(ARCH, quant_proj=mode, dtype="float32")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prompts(vocab, lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lens), int(max(lens))), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(3, vocab, n)
    return prompts


def _smoke_model(**overrides):
    cfg = get_smoke_config(ARCH).replace(quant_proj="none", dtype="float32",
                                         **overrides)
    return cfg, init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_cross_attention_matches_jax(mode):
    """Q from x, K and V from a memory of another length (T != S), no rope,
    dense and non-causal."""
    jcfg, params, tcfg, model = encdec_models(mode)
    x = _normal((2, 7, tcfg.d_model), 1)
    mem = _normal((2, 13, tcfg.d_model), 2)
    pos = np.arange(7)
    y, cache = apply_attention(model.layers[1].cross, _t(x), tcfg,
                               positions=_t(pos), memory=_t(mem))
    jp = jax.tree.map(lambda a: a[1], params["layers"]["cross"])
    want, _ = jax_attention.apply_attention(jp, jnp.asarray(x), jcfg,
                                            positions=jnp.asarray(pos),
                                            memory=jnp.asarray(mem))
    assert cache is None and y.shape == (2, 7, tcfg.d_model)
    assert rel_err(y.numpy(), want) <= TOL[mode]


def test_cross_attention_refuses_a_cache():
    _, _, tcfg, model = encdec_models()
    x = torch.zeros((1, 1, tcfg.d_model))
    kv = torch.zeros((1, 4, tcfg.n_kv_heads, tcfg.head_dim))
    with pytest.raises(ValueError, match="takes no cache"):
        apply_attention(model.layers[0].cross, x, tcfg,
                        positions=torch.zeros((1, 1), dtype=torch.long),
                        memory=x, cache=(kv, kv),
                        cache_pos=torch.zeros(1, dtype=torch.long))


@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("frames", [24, 80])   # below / above threshold 64
def test_encode_matches_jax(frames, mode):
    jcfg, params, tcfg, model = encdec_models(mode)
    assert (frames >= tcfg.blockwise_attn_threshold) == (frames == 80)
    fr = _normal((2, frames, tcfg.d_model), 3)
    mem = encode(model, _t(fr), tcfg)
    want = jax_encode(params, jnp.asarray(fr), jcfg)
    assert mem.shape == (2, frames, tcfg.d_model)
    assert rel_err(mem.numpy(), want) <= TOL[mode]


@pytest.mark.parametrize("frames,route", [(24, "_attend_dense"),
                                          (80, "flash_attention")])
def test_encoder_attends_without_the_causal_mask(frames, route, monkeypatch):
    """Below the threshold the dense attend, at it ``flash_attention``,
    both with ``causal=False``; the encoder's output at frame 0 depends on
    the last frame."""
    from repro_torch.models import attention as port_attention
    cfg, model = _smoke_model()
    seen = []
    fn = getattr(port_attention, route)
    monkeypatch.setattr(port_attention, route,
                        lambda *a, **kw: seen.append(kw["causal"])
                        or fn(*a, **kw))
    fr = torch.from_numpy(_normal((1, frames, cfg.d_model), 4))
    mem = encode(model, fr, cfg)
    assert seen == [False] * cfg.n_encoder_layers
    fr2 = fr.clone()
    fr2[0, -1] += 1.0
    assert not torch.equal(encode(model, fr2, cfg)[0, 0], mem[0, 0])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_apply_model_encoder_frames_matches_jax(mode):
    jcfg, params, tcfg, model = encdec_models(mode)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    fr = _normal((2, FRAMES, tcfg.d_model), 6)
    logits, cache, _ = apply_model(model, _t(toks), tcfg,
                                   encoder_frames=_t(fr))
    want, _, _ = jax_apply_model(params, jnp.asarray(toks), jcfg,
                                 encoder_frames=jnp.asarray(fr))
    assert cache is None and logits.shape == (2, 12, tcfg.vocab_size)
    assert rel_err(logits.numpy(), want) <= TOL[mode]


def test_memory_equals_inline_encoding():
    """Precomputed memory == inline encoding (the serving contract), as
    ``tests/test_system.py`` holds the JAX package."""
    cfg, model = _smoke_model()
    fr = torch.from_numpy(_normal((2, 8, cfg.d_model), 6))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)))
    l1, _, _ = apply_model(model, toks, cfg, encoder_frames=fr)
    l2, _, _ = apply_model(model, toks, cfg, memory=encode(model, fr, cfg))
    torch.testing.assert_close(l1, l2, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_matches_full_forward(layout):
    """Token-by-token ``serve_step`` with memory equals the cache-less
    forward on the frames (the seamless case of ``tests/test_decode.py``)."""
    cfg, model = _smoke_model()
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)))
    fr = torch.from_numpy(_normal((b, 8, cfg.d_model), 2))
    memory = encode(model, fr, cfg)
    full, _, _ = apply_model(model, toks, cfg, encoder_frames=fr)
    config = CacheConfig(**PAGED) if layout == "paged" else None
    cache = init_cache(cfg, b, 16, torch.float32, config, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = serve_step(model, cache, toks[:, t:t + 1], t, cfg,
                               memory=memory)
        outs.append(lg)
    assert rel_err(torch.cat(outs, 1).numpy(), full.numpy()) < 5e-5


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["none", "w8a8"])
@pytest.mark.parametrize("chunk", [None, 4])
def test_greedy_tokens_equal_jax_engine(layout, mode, chunk):
    """``encode`` → ``prefill(memory=)`` (one pass or chunked, mixed prompt
    lengths) → ``greedy_decode(memory=)``: memory and first logits within
    the tolerance, tokens equal the JAX engine's."""
    jcfg, params, tcfg, model = encdec_models(mode)
    prompts = _prompts(tcfg.vocab_size)
    fr = _normal((len(LENS), FRAMES, tcfg.d_model), 8)
    memory = encode(model, _t(fr), tcfg)
    jmem = jax_encode(params, jnp.asarray(fr), jcfg)
    assert rel_err(memory.numpy(), jmem) <= TOL[mode]
    paged = layout == "paged"
    cache = init_cache(tcfg, len(LENS), 32, torch.float32,
                       CacheConfig(**PAGED) if paged else None,
                       device="cpu")
    jcache = jax_init_cache(jcfg, len(LENS), 32, dtype=jnp.float32,
                            config=JaxCacheConfig(**PAGED) if paged
                            else None)
    nl, cache = prefill(model, cache, _t(prompts), _t(LENS), tcfg,
                        memory=memory, chunk=chunk)
    jnl, jcache = jax_prefill(params, jcache, jnp.asarray(prompts),
                              jnp.asarray(LENS), jcfg, memory=jmem,
                              chunk=chunk)
    assert rel_err(nl.numpy(), jnl) <= TOL[mode]
    first = torch.argmax(nl, -1)[:, None]
    start = None if paged else _t(LENS)
    toks, cache = greedy_decode(model, cache, first, start, N_STEPS, tcfg,
                                memory=memory)
    jfirst = jnp.argmax(jnl, -1)[:, None].astype(jnp.int32)
    jtoks, _ = jax_greedy_decode(params, jcache, jfirst,
                                 None if paged else jnp.asarray(LENS),
                                 N_STEPS, jcfg, memory=jmem)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    if paged:
        assert cache["seq_lens"].tolist() == (LENS + N_STEPS).tolist()


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_prefill_step_encoder_frames_matches_jax(mode):
    """The cache-less entry on frames past the threshold: the encoder
    through ``flash_attention``'s plain version, the decoder's short
    prompt dense."""
    jcfg, params, tcfg, model = encdec_models(mode)
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (1, 16)).astype(np.int32)
    fr = _normal((1, 96, tcfg.d_model), 10)
    logits, aux = prefill_step(model, _t(toks), tcfg, encoder_frames=_t(fr))
    want, _ = jax_prefill_step(params, jnp.asarray(toks), jcfg,
                               encoder_frames=jnp.asarray(fr))
    assert logits.shape == (1, 16, tcfg.vocab_size)
    assert rel_err(logits.numpy(), want) <= TOL[mode]
    assert float(aux["load_balance_loss"]) == 0.0


# ---------------------------------------------------------------------------
# the bridge, the quantization walk, the cache
# ---------------------------------------------------------------------------
def _same_linear(lin, node, i, quant):
    if quant == "none":
        np.testing.assert_array_equal(lin.w.numpy(), node["w"][i])
    else:
        assert lin.w is None
        np.testing.assert_array_equal(lin.w_q.values.numpy(),
                                      node["w_q"]["values"][i])
        np.testing.assert_array_equal(lin.w_q.scale.numpy(),
                                      node["w_q"]["scale"][i])
    if "b" in node:
        np.testing.assert_array_equal(lin.b.numpy(), node["b"][i])


def _same_norm(norm, node, i=None):
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    np.testing.assert_array_equal(norm.w.numpy(), pick(node["w"]))
    if "b" in node:
        np.testing.assert_array_equal(norm.b.numpy(), pick(node["b"]))


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_bridge_copies_every_leaf(quant):
    """The encoder stack and its final norm, each decoder block's
    self-attention, ``norm_cross`` and ``cross``, and the untied head."""
    _, params, tcfg, model = encdec_models(quant)
    tree = numpy_tree(params)
    enc, layers = tree["encoder"], tree["layers"]
    assert isinstance(model.encoder, Encoder)
    assert len(model.encoder.layers) == tcfg.n_encoder_layers
    for stack, blocks, cross in ((enc["layers"], model.encoder.layers,
                                  False),
                                 (layers, model.layers, True)):
        for i, block in enumerate(blocks):
            assert isinstance(block, DecoderBlock)
            for name in ("wq", "wk", "wv", "wo"):
                _same_linear(getattr(block.attn, name),
                             stack["attn"][name], i, quant)
                if cross:
                    _same_linear(getattr(block.cross, name),
                                 stack["cross"][name], i, quant)
            for name in ("up", "down"):
                _same_linear(getattr(block.ffn, name), stack["ffn"][name],
                             i, quant)
            for name in ("norm_attn", "norm_ffn") + (("norm_cross",)
                                                     if cross else ()):
                _same_norm(getattr(block, name), stack[name], i)
            if not cross:
                assert block.cross is None and block.norm_cross is None
    _same_norm(model.encoder.final_norm, enc["final_norm"])
    _same_norm(model.final_norm, tree["final_norm"])
    np.testing.assert_array_equal(model.lm_head.w.numpy(),
                                  tree["lm_head"]["w"])
    np.testing.assert_array_equal(model.embed.table.numpy(),
                                  tree["embed"]["table"])


def test_quantize_model_params_reaches_cross_and_encoder():
    """The walk quantizes every projection of the encoder blocks, of the
    decoder's self- and cross-attention and FFNs; norms (``norm_cross``
    among them), the embedding and the head stay f32; quantizing block by
    block as drawn gives the same model."""
    cfg = get_smoke_config(ARCH)
    master = init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    whole = quantize_model_params(master)
    blocks = list(whole.encoder.layers) + list(whole.layers)
    for block in blocks:
        attns = [block.attn] + ([block.cross] if block.cross is not None
                                else [])
        for lin in [getattr(a, n) for a in attns
                    for n in ("wq", "wk", "wv", "wo")] + [block.ffn.up,
                                                         block.ffn.down]:
            assert lin.w is None and lin.w_q.values.dtype == torch.int8
            assert lin.w_q.values.t().is_contiguous()          # K-major
    assert all(b.cross is not None for b in whole.layers)
    assert whole.layers[0].norm_cross.w.dtype == torch.float32
    assert whole.lm_head.w.dtype == torch.float32
    assert master.layers[0].cross.wq.w is not None       # input untouched
    each = init_model(torch.Generator().manual_seed(3), cfg, device="cpu",
                      each_block=quantize_model_params)
    b1, b2 = dict(whole.named_buffers()), dict(each.named_buffers())
    assert b1.keys() == b2.keys()
    for name in b1:
        assert torch.equal(b1[name], b2[name]), name


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_init_cache_holds_decoder_self_attention_only(layout):
    """The cache is the JAX package's: self-attention KV of the n_layers
    decoder layers (nothing for the encoder or for cross-attention)."""
    jcfg, _, tcfg, _ = encdec_models()
    paged = layout == "paged"
    cache = init_cache(tcfg, 2, 16, torch.float32,
                       CacheConfig(**PAGED) if paged else None, device="cpu")
    jcache = jax_init_cache(jcfg, 2, 16, dtype=jnp.float32,
                            config=JaxCacheConfig(**PAGED) if paged
                            else None)
    assert cache.keys() == jcache.keys()
    for key in cache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
    assert cache["k_pages" if paged else "k"].shape[0] == tcfg.n_layers
    assert isinstance(state_handler(tcfg), PagedKVHandler)


# ---------------------------------------------------------------------------
# what the port refuses where the JAX package would drop an input
# ---------------------------------------------------------------------------
def _guard_case(case):
    """(config, call) for one refusal: each call runs ``apply_model`` (or
    an entry point over it) with an input the JAX package would drop, or
    without one it would fail on without saying why."""
    cfg, model = _smoke_model()
    toks = torch.zeros((2, 3), dtype=torch.long)
    fr = torch.zeros((2, 8, cfg.d_model))
    cache = init_cache(cfg, 2, 16, torch.float32, device="cpu")
    if case == "cached call without memory":
        return lambda: serve_step(model, cache, toks[:, :1], 0, cfg)
    if case == "prefill without memory":
        return lambda: prefill(model, cache, toks, torch.tensor([3, 2]), cfg)
    if case == "frames on a cached call":
        return lambda: apply_model(model, toks, cfg, cache=cache,
                                   cache_pos=0, encoder_frames=fr)
    if case == "no cache, no memory, no frames":
        return lambda: apply_model(model, toks, cfg)
    if case == "frames and memory":
        return lambda: apply_model(model, toks, cfg, encoder_frames=fr,
                                   memory=fr)
    if case == "frontend_embeds with a cache":
        return lambda: apply_model(model, toks, cfg, cache=cache,
                                   cache_pos=0, memory=fr,
                                   frontend_embeds=fr)
    if case == "spec_step (takes no memory)":
        pcfg = CacheConfig(layout="paged", alloc="dynamic", page_size=8)
        pcache = init_cache(cfg, 2, 16, torch.float32, pcfg, device="cpu")
        return lambda: spec_step(model, model, pcache, cache, toks[:, :1],
                                 torch.tensor([4, 4]),
                                 torch.tensor([True, True]), cfg, cfg,
                                 n_draft=2)
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "cached call without memory", "prefill without memory",
    "frames on a cached call", "no cache, no memory, no frames",
    "frames and memory", "frontend_embeds with a cache",
    "spec_step (takes no memory)"])
def test_dropped_inputs_raise(case):
    with pytest.raises(ValueError):
        _guard_case(case)()


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "phi3_vision_4_2b"])
@pytest.mark.parametrize("kw", ["encoder_frames", "memory"])
def test_frames_and_memory_raise_off_the_family(arch, kw):
    """A decoder-only model has no encoder to take frames and no
    cross-attention to take memory."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        apply_model(model, toks, cfg, **{kw: x})


def test_scheduler_refuses_encoder_decoder():
    cfg, model = _smoke_model()
    with pytest.raises(NotImplementedError, match="memory="):
        Scheduler(model, cfg, slots=2, max_len=32, device="cpu")


def test_launcher_refuses_encoder_decoder():
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError, match="encode"):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "1",
              "--prompt-len", "4", "--tokens", "2"])
