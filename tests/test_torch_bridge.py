"""JAX → port weight bridge, and the config registry parity.

Also the shared helpers of the ``test_torch_*`` files: ``numpy_tree`` turns
a JAX params pytree into the numpy tree ``repro_torch.bridge`` takes, and
``paired_models`` builds one model in both packages with the same weights.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core.quantization import QTensor as JaxQTensor
from repro.core.quantize_params import quantize_model_params as jax_quantize
from repro.models.transformer import init_model as jax_init_model
from repro_torch import configs as torch_configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quantized_linear import Linear

SMOKE_ARCHS = ["distilbert_paper", "qwen2_5_3b"]


def numpy_tree(params):
    """JAX params pytree → nested dict of numpy arrays; each QTensor
    becomes ``{"values", "scale", "bits"}``."""
    if isinstance(params, JaxQTensor):
        return {"values": np.asarray(params.values),
                "scale": np.asarray(params.scale), "bits": params.bits}
    if isinstance(params, dict):
        return {k: numpy_tree(v) for k, v in params.items()}
    return np.asarray(params)


def paired_configs(arch: str, **overrides):
    """The same smoke config from both packages."""
    return (jax_configs.get_smoke_config(arch).replace(**overrides),
            torch_configs.get_smoke_config(arch).replace(**overrides))


def paired_models(arch: str, *, seed: int = 0, **overrides):
    """(jax_cfg, jax_params, torch_cfg, torch_model) with the same weights,
    initialised by the JAX package and carried over through numpy.  Under a
    quantizing ``quant_proj`` both hold the JAX package's int8 weights."""
    jcfg, tcfg = paired_configs(arch, **overrides)
    params = jax_init_model(jax.random.PRNGKey(seed),
                            jcfg.replace(quant_proj="none"))
    if jcfg.quant_proj != "none":
        params = jax_quantize(params)
    model = params_from_numpy(numpy_tree(params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("arch", torch_configs.ARCHITECTURES)
def test_configs_match_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        jc = getattr(jax_configs, get)(arch)
        tc = getattr(torch_configs, get)(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert torch_configs.get_config(arch).activation_dtype in (
        torch.bfloat16, torch.float32)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_bridge_copies_every_leaf(arch, quant):
    """Every stacked leaf lands, exactly, in its layer's module."""
    _, params, tcfg, model = paired_models(arch, quant_proj=quant)
    assert len(model.layers) == tcfg.n_layers
    tree = numpy_tree(params)
    np.testing.assert_array_equal(model.embed.table.numpy(),
                                  tree["embed"]["table"])
    for i, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo"):
            lin: Linear = getattr(layer.attn, name)
            node = tree["layers"]["attn"][name]
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
        np.testing.assert_array_equal(layer.norm_ffn.w.numpy(),
                                      tree["layers"]["norm_ffn"]["w"][i])


def _projections(model):
    for layer in model.layers:
        for name in ("wq", "wk", "wv", "wo"):
            yield getattr(layer.attn, name)
        for name in ("gate", "up", "down"):
            lin = getattr(layer.ffn, name, None)
            if lin is not None:
                yield lin


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_bridge_stores_quantized_weights_k_major(arch):
    """Kernel K2/K3 read weights K-major: the bridge stores each quantized
    projection once, (N, K)-contiguous, seen as the (K, N) it copies."""
    _, params, _, model = paired_models(arch, quant_proj="w8a8")
    tree = numpy_tree(params)
    for lin in _projections(model):
        values = lin.w_q.values
        k, n = values.shape
        assert values.stride() == (1, k) and values.t().is_contiguous()
        assert values.untyped_storage().nbytes() == k * n   # one copy
    np.testing.assert_array_equal(
        model.layers[0].attn.wq.w_q.values.numpy(),
        tree["layers"]["attn"]["wq"]["w_q"]["values"][0])


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_quantize_model_params_stores_weights_k_major(arch):
    from repro_torch.core.quantize_params import quantize_model_params
    _, _, _, master = paired_models(arch, quant_proj="none")
    model = quantize_model_params(master)
    for lin, ref in zip(_projections(model), _projections(master)):
        values = lin.w_q.values
        assert values.shape == ref.w.shape
        assert values.t().is_contiguous() and not values.is_contiguous()
