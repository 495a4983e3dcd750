"""Port's vision family (phi-3-vision's smoke config) vs the JAX package, on
weights initialised by the JAX package and carried over through numpy: the
patch embeddings spliced ahead of the text (below and above the blockwise
threshold, the text at positions P..P+S-1), ``prefill_step(
frontend_embeds=)``, the text-only serve on the dense and the paged cache,
decode against the full forward, and the Scheduler against the JAX
Scheduler on the same trace.  Mirrors the phi3-vision cases of
``tests/test_system.py`` and ``tests/test_decode.py``.

Tolerances: rel-err (max |port - jax| / max |jax|) 1e-5 in f32 where no
int8 rounding sits between the two (``none``, ``w8``); decode against the
full forward 5e-5, the JAX package's own limit; tokens exactly.  The
spliced forward under ``w8a8`` is held as ``tests/test_torch_flash.py``
holds long prompts (``_holds``: closer to JAX's w8a8 logits than to its
w8 ones, argmax equal at >= 0.98 of the positions): the patches are
unit-normal rows, and one ulp of difference entering ``quant_act`` can
flip one int8 rounding, which moves every later position through
attention by up to the w8a8 - w8 gap itself (seed 13 of the test's
inputs shows no flip and agrees to 4e-7; others flip and leave 7e-3 to
1.7e-2, as text-only prompts of 76 tokens do).  Serving logits under
``w8a8`` are held at ``test_torch_model.TOL``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import apply_model as jax_apply_model
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro.serving.engine import prefill_step as jax_prefill_step
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import apply_model, init_model
from repro_torch.serving import allocator as al
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import (greedy_decode, prefill, prefill_step,
                                        serve_step)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.state import PagedKVHandler, state_handler
from test_torch_bridge import paired_models, rel_err
from test_torch_flash import _holds, _jax_w8
from test_torch_model import TOL
from test_torch_moe import _cross_family_trace, _drive

ARCH = "phi3_vision_4_2b"
PAGED = dict(layout="paged", page_size=8, alloc="striped")
LENS = np.array([12, 9, 5], np.int32)
N_STEPS = 5


@functools.lru_cache(maxsize=None)
def vlm_models(mode="none"):
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


def _text_and_patches(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, _normal((b, cfg.frontend_len, cfg.d_model), seed + 1)


# ---------------------------------------------------------------------------
# the splice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("text", [24, 60])   # 16 patches + text: 40 / 76
def test_apply_model_frontend_embeds_matches_jax(text, mode):
    """Patches ahead of the text, below and above the threshold (64): the
    logits cover patches and text (``tests/test_system.py``'s shape) and
    equal JAX's, so the text sits at positions P..P+S-1."""
    jcfg, params, tcfg, model = vlm_models(mode)
    toks, patches = _text_and_patches(tcfg, 2, text, 11)
    total = tcfg.frontend_len + text
    assert (total >= tcfg.blockwise_attn_threshold) == (text == 60)
    logits, cache, _ = apply_model(model, _t(toks), tcfg,
                                   frontend_embeds=_t(patches))

    def jax_logits(c):
        return np.asarray(jax_apply_model(
            params, jnp.asarray(toks), c,
            frontend_embeds=jnp.asarray(patches))[0])

    assert cache is None
    assert logits.shape == (2, total, tcfg.vocab_size)
    _holds(logits.numpy(), jax_logits(jcfg), mode,
           _jax_w8(jax_logits, jcfg, mode))


def test_text_follows_the_patches():
    """Positions are formed after the splice: patches that are the
    embeddings of P tokens give the logits of those P tokens followed by
    the text, whose positions run on from P."""
    from repro_torch.models.layers import embed_tokens
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    pre = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, cfg.frontend_len)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8)))
    spliced, _, _ = apply_model(
        model, toks, cfg,
        frontend_embeds=embed_tokens(model.embed, pre, cfg))
    whole, _, _ = apply_model(model, torch.cat([pre, toks], 1), cfg)
    torch.testing.assert_close(spliced, whole, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_prefill_step_frontend_embeds_matches_jax(mode):
    jcfg, params, tcfg, model = vlm_models(mode)
    toks, patches = _text_and_patches(tcfg, 1, 80, 13)
    logits, aux = prefill_step(model, _t(toks), tcfg,
                               frontend_embeds=_t(patches))

    def jax_logits(c):
        return np.asarray(jax_prefill_step(
            params, jnp.asarray(toks), c,
            frontend_embeds=jnp.asarray(patches))[0])

    assert logits.shape == (1, tcfg.frontend_len + 80, tcfg.vocab_size)
    _holds(logits.numpy(), jax_logits(jcfg), mode,
           _jax_w8(jax_logits, jcfg, mode))
    assert float(aux["load_balance_loss"]) == 0.0


def test_frontend_embeds_with_a_cache_raise():
    """The JAX package ignores patches on a cached call; the port says
    decode is text-only."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 1, 16, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="text-only"):
        apply_model(model, torch.zeros((1, 2), dtype=torch.long), cfg,
                    cache=cache, cache_pos=0,
                    frontend_embeds=torch.zeros((1, 3, cfg.d_model)))


# ---------------------------------------------------------------------------
# the text-only serve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_matches_full_forward(layout):
    """Text-only ``serve_step`` token by token equals the cache-less
    forward (the phi3 case of ``tests/test_decode.py``)."""
    cfg = get_smoke_config(ARCH).replace(quant_proj="none", dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    full, _, _ = apply_model(model, toks, cfg)
    config = CacheConfig(**PAGED) if layout == "paged" else None
    cache = init_cache(cfg, 2, 16, torch.float32, config, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = serve_step(model, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg)
    assert rel_err(torch.cat(outs, 1).numpy(), full.numpy()) < 5e-5


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["none", "w8a8"])
@pytest.mark.parametrize("chunk", [None, 4])
def test_greedy_tokens_equal_jax_engine(layout, mode, chunk):
    jcfg, params, tcfg, model = vlm_models(mode)
    prompts = _prompts(tcfg.vocab_size)
    paged = layout == "paged"
    cache = init_cache(tcfg, len(LENS), 32, torch.float32,
                       CacheConfig(**PAGED) if paged else None, device="cpu")
    jcache = jax_init_cache(jcfg, len(LENS), 32, dtype=jnp.float32,
                            config=JaxCacheConfig(**PAGED) if paged
                            else None)
    nl, cache = prefill(model, cache, _t(prompts), _t(LENS), tcfg,
                        chunk=chunk)
    jnl, jcache = jax_prefill(params, jcache, jnp.asarray(prompts),
                              jnp.asarray(LENS), jcfg, chunk=chunk)
    assert rel_err(nl.numpy(), jnl) <= TOL[mode]
    start = None if paged else _t(LENS)
    toks, cache = greedy_decode(model, cache, torch.argmax(nl, -1)[:, None],
                                start, N_STEPS, tcfg)
    jtoks, _ = jax_greedy_decode(
        params, jcache, jnp.argmax(jnl, -1)[:, None].astype(jnp.int32),
        None if paged else jnp.asarray(LENS), N_STEPS, jcfg)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_scheduler_matches_isolated_and_jax():
    """The vision family through the Scheduler (text-only, the paged
    handler): per request, the isolated prefill → greedy_decode tokens,
    and the JAX Scheduler's."""
    jcfg, params, tcfg, model = vlm_models()
    assert isinstance(state_handler(tcfg), PagedKVHandler)
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
        toks, _ = greedy_decode(model, cache, torch.argmax(nl, -1)[:, None],
                                None, m - 1, tcfg)
        np.testing.assert_array_equal(out[rid], toks[0].numpy())
        np.testing.assert_array_equal(out[rid], jout[jrid])
