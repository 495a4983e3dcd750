"""Port's int8 KV page pools (``kv_quant="int8"``) vs the JAX package:
``quantize_kv`` bit for bit, the int8 mode of kernel K4's plain version
against JAX's interpret kernel and oracle, the int8 cache, the decode
cache guards, and the int8 paged serving engine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.quantization import quantize_kv as jax_quantize_kv
from repro.kernels.flash_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantization import qmax_for_bits, quantize_kv
from repro_torch.kernels.flash_attention.ops import paged_decode_attention
from repro_torch.models.transformer import init_model
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import greedy_decode, validate_decode_cache
from test_torch_bridge import paired_models
from test_torch_paged import (LENS, N_STEPS, PAGED, _prompts,
                              jax_paged_serve, paged_inputs, port_serve,
                              to_torch)

INT8 = dict(PAGED, kv_quant="int8")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_equals_jax(dtype):
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 16)).astype(
        np.float32) * 3
    x[1, 2, 1] = 0.0                         # zero row: scale 1
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    values, scales = quantize_kv(tx)
    jvalues, jscales = jax_quantize_kv(jx)
    assert values.dtype == torch.int8 and values.shape == x.shape
    assert scales.dtype == torch.float32 and scales.shape == x.shape[:-1]
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert int(values.abs().max()) <= qmax_for_bits(8)
    assert float(scales[1, 2, 1]) == 1.0 and not values[1, 2, 1].any()


def quant_pools(kp, vp):
    """int8 pools and scale pools of fp pools, row by row (numpy)."""
    kq, ks = jax_quantize_kv(jnp.asarray(kp))
    vq, vs = jax_quantize_kv(jnp.asarray(vp))
    return [np.array(a) for a in (kq, ks, vq, vs)]


INT8_CASES = {
    "mixed_lengths_gqa": (3, 128, 8, 2, 64, 16, [37, 5, 128], {}),
    "window_softcap": (2, 128, 4, 1, 64, 16, [100, 23],
                       dict(window=20, softcap=30.0)),
    "q_len3_window": (2, 64, 4, 2, 32, 8, [33, 17], dict(qs=3, window=12)),
}


@pytest.mark.parametrize("jax_mode", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_plain_paged_attention_matches_jax(case, jax_mode):
    b, t, h, kh, d, page, lens, opts = INT8_CASES[case]
    opts = dict(opts)
    qs = opts.pop("qs", 1)
    q, kp, vp, table, lens = paged_inputs(b, t, h, kh, d, page, lens, qs=qs,
                                          seed=len(case))
    kq, ks, vq, vs = quant_pools(kp, vp)
    tq, tkq, tvq, ttable, tlens, tks, tvs = to_torch(q, kq, vq, table, lens,
                                                     ks, vs)
    out = paged_decode_attention(tq, tkq, tvq, ttable, tlens, k_scales=tks,
                                 v_scales=tvs, **opts)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
        jnp.asarray(lens), k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        mode=jax_mode, **opts)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-6,
                               rtol=1e-5)
    # the int8 mode is the fp mode on pools dequantized beforehand
    fp = paged_decode_attention(tq, tkq.float() * tks[..., None],
                                tvq.float() * tvs[..., None], ttable, tlens,
                                **opts)
    torch.testing.assert_close(out, fp, rtol=0, atol=0)


def test_init_cache_int8_equals_jax_and_errors():
    tcfg = get_smoke_config("qwen2_5_3b")
    jcfg = jax_get_smoke_config("qwen2_5_3b")
    cache = init_cache(tcfg, 2, 40, torch.bfloat16,
                       CacheConfig(layout="paged", page_size=16,
                                   kv_quant="int8"), device="cpu")
    jcache = jax_init_cache(jcfg, 2, max_len=40, dtype=jnp.bfloat16,
                            config=JaxCacheConfig(layout="paged",
                                                  page_size=16,
                                                  kv_quant="int8"))
    assert set(cache) == set(jcache)
    for key, val in cache.items():
        assert tuple(val.shape) == jcache[key].shape, key
        assert str(val.dtype).split(".")[-1] == str(jcache[key].dtype), key
    assert cache["k_scales"].shape == (tcfg.n_layers, 6, 16, tcfg.n_kv_heads)
    with pytest.raises(ValueError, match="layout='paged'"):
        init_cache(tcfg, 2, 40, config=CacheConfig(kv_quant="int8"),
                   device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        init_cache(tcfg, 2, 40, config=CacheConfig(layout="paged",
                                                   kv_quant="int4"),
                   device="cpu")


def test_unsupported_cache_combos_raise():
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    cache = init_cache(cfg, 1, 16, torch.float32,
                       CacheConfig(layout="paged", page_size=8,
                                   kv_quant="int8"), device="cpu")
    validate_decode_cache(cache, cfg)
    broken = {k: v for k, v in cache.items()
              if k not in ("k_scales", "v_scales")}
    with pytest.raises(NotImplementedError,
                       match=r"layout='paged', kv dtype torch.int8, "
                             r"kv_quant=none"):
        validate_decode_cache(broken, cfg)
    half = {k: v for k, v in cache.items() if k != "v_scales"}
    with pytest.raises(NotImplementedError, match="BOTH"):
        validate_decode_cache(half, cfg)
    mixed = dict(cache, k_pages=cache["k_pages"].float(),
                 v_pages=cache["v_pages"].float())
    with pytest.raises(NotImplementedError, match="not int8"):
        validate_decode_cache(mixed, cfg)
    dense = init_cache(cfg, 1, 16, torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match=r"layout='dense'"):
        validate_decode_cache(dense, cfg)
    other = init_cache(cfg.replace(n_kv_heads=1), 1, 16, torch.float32,
                       CacheConfig(layout="paged", kv_quant="int8"),
                       device="cpu")
    with pytest.raises(ValueError, match="different model config"):
        validate_decode_cache(other, cfg)


def test_greedy_decode_rejects_scaleless_int8():
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 1, 16, torch.float32,
                       CacheConfig(layout="paged", page_size=8,
                                   kv_quant="int8"), device="cpu")
    broken = {k: v for k, v in cache.items()
              if k not in ("k_scales", "v_scales")}
    with pytest.raises(NotImplementedError, match="kv_quant=none"):
        greedy_decode(model, broken, torch.zeros((1, 1), dtype=torch.long),
                      None, 2, cfg)


@pytest.mark.parametrize("arch,mode", [("distilbert_paper", "none"),
                                       ("distilbert_paper", "w8a8"),
                                       ("qwen2_5_3b", "none"),
                                       ("gemma2_27b", "none")])
def test_int8_paged_greedy_tokens_equal_jax_engine(arch, mode):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32")
    prompts = _prompts(jcfg.vocab_size)
    want = jax_paged_serve(jcfg, params, prompts, **INT8)
    _, toks, cache = port_serve(tcfg, model, prompts, CacheConfig(**INT8))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert cache["k_pages"].dtype == torch.int8
    # each written (slot, kv-head) row has its scale, the others keep 0:
    # prefill wrote S_pad slots per sequence, decode one more per step
    s_pad = int(LENS.max())
    written = sum(max(s_pad, int(n) + N_STEPS) for n in LENS)
    assert int((cache["k_scales"][0] > 0).sum()) == written * tcfg.n_kv_heads
