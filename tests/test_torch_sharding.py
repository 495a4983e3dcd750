"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's: rule tables, logical axes of parameter paths, resolved
placements of activations, and every parameter's placement for every
config at full size over serving, training and multi-pod meshes.

The port's full-size parameter names and shapes come from ``init_model``
under ``FakeTensorMode`` (no memory), the JAX package's from
``jax.eval_shape``; each port tensor is held to its JAX leaf (a layer's
tensor to its stacked leaf without the layer axis), entry for entry.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.quantize_params import quantize_model_params as jax_quantize
from repro.launch import sharding as jsh
from repro.models.transformer import init_model as jax_init_model
from repro_torch import tree as ptree
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.launch import sharding as psh
from repro_torch.models.transformer import init_model


class FakeMesh:
    """Duck-typed mesh (axis extents only), as the JAX tests use."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {f"model{m}": FakeMesh(model=m) for m in (1, 2, 4, 8, 16)}
MESHES.update(prod=FakeMesh(data=16, model=16),
              pod=FakeMesh(pod=2, data=16, model=16),
              host=FakeMesh(data=2, model=4))
RULE_SETS = {"tp": dict(fsdp=False, profile="tp"),
             "tp-fsdp": dict(fsdp=True, profile="tp"),
             "dp": dict(fsdp=False, profile="dp"),
             "dp-fsdp": dict(fsdp=True, profile="dp")}


def _jax_spec(*args, **kwargs):
    return tuple(jsh.spec_for(*args, **kwargs))


# ---------------------------------------------------------------------------
# rule tables and paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rules", list(RULE_SETS))
def test_param_rules_equal_the_jax_packages(rules):
    assert psh.make_param_rules(**RULE_SETS[rules]) == \
        jsh.make_param_rules(**RULE_SETS[rules])


@pytest.mark.parametrize("profile", ["tp", "dp"])
def test_activation_rules_equal_the_jax_packages(profile):
    assert psh.make_activation_rules(profile) == \
        jsh.make_activation_rules(profile)
    assert psh.DEFAULT_LOGICAL_RULES == jsh.DEFAULT_LOGICAL_RULES
    assert psh.PARAM_RULES == jsh.PARAM_RULES


PATHS = [("layers/attn/wq/w", 3), ("layers/attn/wk/w_q/values", 3),
         ("layers/attn/wk/w_q/scale", 3), ("layers/attn/wq/b", 2),
         ("layers/attn/wo/w", 3), ("layers/ffn/down/w_q/values", 3),
         ("layers/moe/experts/gate", 4), ("layers/moe/router/w", 3),
         ("embed/table", 2), ("lm_head/w", 2), ("layers/norm_attn/w", 2),
         ("layers/mamba/in_z/w", 3), ("layers/mamba/in_B/w", 3),
         ("layers/mamba/conv_x/w", 3), ("layers/mamba/ssm/A_log", 2),
         ("final_norm/w", 1), ("layers/attn/q_norm/w", 2),
         ("unmatched/thing", 2), ("embed/table", 1), ("layers/attn/wq/w", 1)]


@pytest.mark.parametrize("path,ndim", PATHS)
def test_logical_axes_for_path(path, ndim):
    assert psh.logical_axes_for_path(path, ndim) == \
        jsh.logical_axes_for_path(path, ndim)


# the JAX package's own unit cases (tests/test_sharding.py), each also held
# entry for entry to the JAX package's spec_for: (shape, logical axes,
# mesh, rules, the placement test_sharding.py asserts or None)
MESH = FakeMesh(data=16, model=16)
MESH3 = FakeMesh(pod=2, data=16, model=16)
TP, DP = psh.make_activation_rules("tp"), psh.make_activation_rules("dp")
FSDP = psh.make_param_rules(fsdp=True)
UNIT_CASES = {
    "kv_heads 8 on model 16: replicated": (
        (32, 128, 8, 64), ("batch", None, "kv_heads", None), MESH, TP,
        ("data", None, None, None)),
    "kv_heads 16 on model 16": (
        (32, 128, 16, 64), ("batch", None, "kv_heads", None), MESH, TP,
        ("data", None, "model", None)),
    "batch 1 long context: kv over (data, model)": (
        (46, 1, 524288, 16, 128), (None, "batch", "kv_seq", None, None),
        MESH, TP, (None, None, ("data", "model"), None, None)),
    "batched decode: kv_seq falls back to model": (
        (46, 128, 32768, 16, 128), (None, "batch", "kv_seq", None, None),
        MESH, TP, (None, "data", "model", None, None)),
    "multi-pod batch": ((256, 4096), ("batch", None), MESH3, TP,
                        (("pod", "data"), None)),
    "dp claims model": ((256, 4096), ("batch", None), MESH, DP,
                        (("data", "model"), None)),
    "dp: mlp cannot reuse model": (
        (256, 64, 2048), ("batch", None, "mlp"), MESH, DP,
        (("data", "model"), None, None)),
    "fsdp keeps tables off data": ((256000, 4608), ("vocab", "table_embed"),
                                   MESH, FSDP, ("model", None)),
    "fsdp embed on data": ((4608, 36864), ("embed", "mlp"), MESH, FSDP,
                           ("data", "model")),
    "paged pool pages on the serving axis": (
        (36, 40, 16, 2, 128), (None, "kv_pages", None, "kv_heads", None),
        FakeMesh(model=4), TP, (None, "model", None, None, None)),
    "multi-pod kv_pages chain": (
        (36, 1024, 16, 2, 128), (None, "kv_pages", None, None, None), MESH3,
        TP, (None, ("pod", "data", "model"), None, None, None)),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_spec_for_unit_cases(case):
    shape, axes, mesh, rules, want = UNIT_CASES[case]
    got = psh.spec_for(shape, axes, mesh, rules)
    assert got == _jax_spec(shape, axes, mesh, rules)
    assert got == want


def test_spec_for_refuses_mismatched_axes():
    with pytest.raises(ValueError):
        psh.spec_for((2, 3), ("batch",), MESH)


# ---------------------------------------------------------------------------
# every parameter of every config at full size
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def port_shapes(arch: str) -> dict:
    """{port tensor name: shape} of ``arch`` at full size, allocated in
    no memory (the initialisers' values are never used)."""
    saved = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *a, **k: t
    try:
        with FakeTensorMode():
            model = init_model(torch.Generator().manual_seed(0),
                               get_config(arch), device="cpu")
            return psh.model_param_shapes(model)
    finally:
        torch.nn.init.trunc_normal_ = saved


@functools.lru_cache(maxsize=None)
def jax_shapes(arch: str) -> dict:
    """{``|``-joined JAX path: shape} of ``arch``'s params at full size."""
    cfg = jax_get_config(arch)
    tree = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0),
                                                 cfg))
    return {jsh._path_str(path).replace("/", ptree.SEP): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_param_spec(shapes: dict, name: str, mesh, rules) -> tuple:
    """The JAX package's placement of the leaf that port tensor ``name``
    belongs to, without the layer axis for a stacked leaf."""
    key = ptree.jax_key(name)
    shape = shapes[key]
    spec = _jax_spec(shape, jsh.logical_axes_for_path(
        key.replace(ptree.SEP, "/"), len(shape)), mesh, rules)
    return spec[1:] if ptree.is_stacked(name) else spec


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_equal_the_jax_packages_at_full_size(arch):
    pshapes, jshapes = port_shapes(arch), jax_shapes(arch)
    keys = {ptree.jax_key(n) for n in pshapes}
    assert keys == set(jshapes)
    for name, shape in pshapes.items():
        jshape = jshapes[ptree.jax_key(name)]
        assert tuple(shape) == (jshape[1:] if ptree.is_stacked(name)
                                else jshape), name
    for mesh in MESHES.values():
        for rules in RULE_SETS.values():
            prules = psh.make_param_rules(**rules)
            got = psh.param_specs(pshapes, mesh, prules)
            for name, spec in got.items():
                assert spec == _jax_param_spec(jshapes, name, mesh,
                                               prules), (name, mesh.shape,
                                                         rules)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "mistral_large_123b",
                                  "gemma2_27b", "qwen3_moe_30b_a3b",
                                  "zamba2_7b"])
def test_quantized_param_specs_equal_the_jax_packages(arch):
    """Quantized leaves (``w_q/values``, ``w_q/scale``, expert stacks) at
    smoke size, through the JAX package's params tree itself and
    ``param_specs``."""
    jcfg = jax_smoke_config(arch)
    params = jax_quantize(jax_init_model(jax.random.PRNGKey(0), jcfg))
    cfg = get_smoke_config(arch)
    model = quantize_model_params(
        init_model(torch.Generator().manual_seed(0), cfg, device="cpu"),
        quantize_experts=cfg.is_moe)
    pshapes = psh.model_param_shapes(model)
    for m in (2, 4):
        mesh = FakeMesh(model=m)
        want = jsh.param_specs(jax.eval_shape(lambda: params), mesh)
        flat = {jsh._path_str(p).replace("/", ptree.SEP): tuple(s)
                for p, s in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        for name, spec in psh.param_specs(pshapes, mesh).items():
            key = ptree.jax_key(name)
            if key not in flat:                 # bits of a QTensor
                continue
            jspec = flat[key]
            jspec = jspec + (None,) * (len(spec) + ptree.is_stacked(name)
                                       - len(jspec))
            assert spec == (jspec[1:] if ptree.is_stacked(name) else jspec), \
                (name, m)


def test_tree_specs_of_a_cache_equal_the_jax_packages():
    shapes = {"k_pages": (36, 40, 16, 2, 128), "page_table": (4, 32),
              "alloc_free": (4, 10)}
    axes = {"k_pages": (None, "kv_pages", None, "kv_heads", None),
            "page_table": ("batch", None), "alloc_free": ("kv_pages", None)}
    for mesh in MESHES.values():
        want = jsh.tree_specs(
            {k: np.zeros(s, np.int8) for k, s in shapes.items()}, axes,
            mesh)
        assert psh.tree_specs(shapes, axes, mesh) == \
            {k: tuple(v) for k, v in want.items()}
