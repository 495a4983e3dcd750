"""Port's projections and dense forward pass vs the JAX package, f32, on
JAX-initialised smoke weights carried over through numpy.

Tolerances (rel-err = max |port - jax| / max |jax|): 1e-5 where no int8
rounding sits between the two (``none``, ``w8``), 2e-3 for ``w8a8``: the
two frameworks' reductions and ``rsqrt`` differ in the last bit, and one
such ulp entering ``quant_act`` can flip one int8 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.qkv_fusion import apply_fused_qkv as jax_fused_qkv
from repro.core.quantized_linear import apply_linear as jax_apply_linear
from repro.core.quantized_linear import init_linear as jax_init_linear
from repro.core.quantized_linear import quantize_linear as jax_quantize_linear
from repro.models.transformer import apply_model as jax_apply_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.qkv_fusion import apply_fused_qkv
from repro_torch.core.quantized_linear import (Linear, apply_linear,
                                               quantize_linear)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import apply_model, init_model
from repro_torch.serving.cache import init_cache
from test_torch_bridge import SMOKE_ARCHS, paired_models, rel_err

TOL = {"none": 1e-5, "w8": 1e-5, "w8a8": 2e-3}


def _linear_pair(k, n, *, bias, quantized, seed):
    params = jax_init_linear(jax.random.PRNGKey(seed), k, n, use_bias=bias)
    if bias:
        params["b"] = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,))
    b = torch.tensor(np.asarray(params["b"])) if bias else None
    lin = Linear(w=torch.tensor(np.asarray(params["w"])), b=b)
    if quantized:
        params, lin = jax_quantize_linear(params), quantize_linear(lin)
    return params, lin


@pytest.mark.parametrize("mode,quantized", [
    ("none", False), ("w8", False), ("w8", True), ("w8a8", False),
    ("w8a8", True)])           # False: quantized on the fly from master w
@pytest.mark.parametrize("shape", [(6, 48), (2, 5, 48)])
def test_apply_linear_matches_jax(mode, quantized, shape):
    params, lin = _linear_pair(48, 40, bias=True, quantized=quantized, seed=3)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    y = apply_linear(lin, torch.from_numpy(x), mode=mode)
    yj = jax_apply_linear(params, jnp.asarray(x), mode=mode)
    assert y.shape == shape[:-1] + (40,) and y.dtype == torch.float32
    assert rel_err(y.numpy(), yj) <= TOL[mode]


@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("nkv", [32, 16])
def test_apply_fused_qkv_matches_jax(mode, nkv):
    pairs = [_linear_pair(32, n, bias=True, quantized=(mode != "none"),
                          seed=10 + i)
             for i, n in enumerate((32, nkv, nkv))]
    x = np.random.default_rng(1).normal(size=(2, 7, 32)).astype(np.float32)
    outs = apply_fused_qkv(*[p[1] for p in pairs], torch.from_numpy(x),
                           mode=mode)
    refs = jax_fused_qkv(*[p[0] for p in pairs], jnp.asarray(x), mode=mode)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        assert rel_err(o.numpy(), r) <= TOL[mode]


# gemma2: sliding window (16 < S) on alternate layers, attention and final
# softcaps, sandwich norms, embed scale; chatglm3: partial rope
@pytest.mark.parametrize("arch", SMOKE_ARCHS + ["gemma2_27b", "chatglm3_6b"])
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_apply_model_matches_jax(arch, mode):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32")
    # no-cache length below blockwise_attn_threshold (64 for qwen2.5 smoke)
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    logits, cache, aux = apply_model(model, torch.from_numpy(toks), tcfg)
    ref, _, _ = jax_apply_model(params, jnp.asarray(toks), jcfg)
    assert cache is None and logits.dtype == torch.float32
    assert logits.shape == (2, 24, jcfg.vocab_size)
    assert rel_err(logits.numpy(), ref) <= TOL[mode]
    assert float(aux["load_balance_loss"]) == 0.0


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "phi3_vision_4_2b"])
def test_other_families_raise(arch):
    """The JAX package's vision and encoder-decoder configs, carried over
    field for field, build a model and a cache (the encoder only for the
    encoder-decoder); a family the port does not know is refused by both."""
    cfg = ModelConfig(**dataclasses.asdict(jax_configs.get_smoke_config(arch)))
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert (model.encoder is not None) == cfg.is_encoder_decoder
    assert len(model.layers) == cfg.n_layers
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape[:3] == (cfg.n_layers, 2, 8)
    unknown = cfg.replace(family="retrieval")
    with pytest.raises(NotImplementedError, match="unknown family"):
        init_model(torch.Generator().manual_seed(0), unknown, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown family"):
        init_cache(unknown, 2, 8, device="cpu")


def test_init_model_is_seeded_and_quantizes():
    from repro_torch.core.quantize_params import quantize_model_params
    cfg = get_smoke_config("distilbert_paper")
    m1 = init_model(torch.Generator().manual_seed(5), cfg, device="cpu")
    m2 = init_model(torch.Generator().manual_seed(5), cfg, device="cpu")
    for (n1, b1), (n2, b2) in zip(m1.named_buffers(), m2.named_buffers()):
        assert n1 == n2 and torch.equal(b1, b2)
    q = quantize_model_params(m1)
    layer = q.layers[0]
    for name in ("wq", "wk", "wv", "wo"):
        lin = getattr(layer.attn, name)
        assert lin.w is None and lin.w_q.values.dtype == torch.int8
    assert layer.ffn.up.w_q is not None and layer.ffn.down.w_q is not None
    assert m1.layers[0].attn.wq.w is not None       # the input is untouched
    assert q.embed.table.dtype == torch.float32
