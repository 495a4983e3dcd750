"""The port's placement dry run (``launch/dryrun.py``), its shape cells
(``launch/shapes.py``) and ``roofline/model_flops.py`` against the JAX
package's.

The JAX package's parameter trees come from ``jax.eval_shape`` (no
memory), quantized for serving cells as its dry run quantizes them; its
placements from its own ``param_specs`` / ``tree_specs`` on a stand-in
mesh with only a ``shape``, as ``tests/test_torch_sharding.py`` does.  Each
rank's bytes implied by those placements must equal the port's record:
parameters, optimizer state (a train cell's ZeRO-1 layout: the bf16
compute copy by the compute rules, the f32 master and moments by the FSDP
rules), the decode cell's cache, the inputs.
"""
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.quantize_params import quantize_model_params as jax_quantize
from repro.launch import shapes as jshapes
from repro.launch import sharding as jsh
from repro.models.transformer import init_model as jax_init_model
from repro.roofline.model_flops import model_flops as jax_model_flops
from repro.serving.cache import cache_logical_axes as jax_cache_axes
from repro.serving.cache import init_cache as jax_init_cache
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import PlacementMesh, make_production_mesh
from repro_torch.roofline.model_flops import count_params, model_flops

# the dense, MoE, SSM and hybrid families the dry run places
PLACED = ["qwen2_5_3b", "gemma2_27b", "chatglm3_6b", "mistral_large_123b",
          "qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "mamba2_370m",
          "zamba2_7b"]
# the encoder-decoder and vision families, which it placed last
REFUSED = {"seamless_m4t_medium": "audio", "phi3_vision_4_2b": "vlm"}
MESHES = {"single": False, "multi": True}
SHAPES_KIND = {k: c.kind for k, c in shapes.SHAPES.items()}


def test_shapes_and_cells_equal_the_jax_packages():
    assert {k: (c.name, c.kind, c.seq_len, c.global_batch)
            for k, c in shapes.SHAPES.items()} == \
        {k: (c.name, c.kind, c.seq_len, c.global_batch)
         for k, c in jshapes.SHAPES.items()}
    assert shapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES
    assert shapes.ENCDEC_DECODE_MEMORY_LEN == \
        jshapes.ENCDEC_DECODE_MEMORY_LEN
    for arch in ARCHITECTURES:
        assert shapes.cells_for(get_config(arch)) == \
            jshapes.cells_for(jax_get_config(arch))


def test_production_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert dryrun.lower_cell("qwen2_5_3b", "decode_32k", multi_pod=True,
                             verbose=False)["chips"] == 512


def _cell_cfg(cfg, kind):
    """The config a cell of ``kind`` runs (the JAX dry run's)."""
    if kind == "train":
        return cfg.replace(quant_proj="none", dtype="bfloat16")
    return cfg.replace(quant_proj="w8a8", dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _jax_params(arch, quantized):
    cfg = _cell_cfg(jax_get_config(arch), "decode" if quantized else "train")

    def build(key):
        p = jax_init_model(key, cfg)
        if quantized:
            p = jax_quantize(p, quantize_experts=cfg.is_moe)
        return p

    return jax.eval_shape(build, jax.random.PRNGKey(0))


def _port_shapes(arch, quantized):
    cfg = _cell_cfg(get_config(arch), "decode" if quantized else "train")
    return {n: s for n, (s, _) in dryrun.params_shape_for(
        cfg, quantized=quantized).items()}


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_model_flops_equal_the_jax_packages(arch):
    for shape in jshapes.cells_for(jax_get_config(arch)):
        cell = jshapes.SHAPES[shape]
        quantized = cell.kind != "train"
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                      else 1)
        kw = dict(kind=cell.kind, tokens=tokens, kv_len=cell.seq_len,
                  batch=cell.global_batch)
        want = jax_model_flops(_cell_cfg(jax_get_config(arch), cell.kind),
                               _jax_params(arch, quantized), **kw)
        got = model_flops(_cell_cfg(get_config(arch), cell.kind),
                          _port_shapes(arch, quantized), **kw)
        assert got == want, (arch, shape)
    assert count_params(_port_shapes(arch, False), exclude_embed=False) == \
        sum(math.prod(x.shape) for x in
            jax.tree.leaves(_jax_params(arch, False)))


def _local(shape, spec, mesh) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n


def _tree_bytes(tree, specs, mesh, dtype_of=lambda leaf: leaf.dtype) -> int:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    return sum(_local(leaf.shape, spec_leaves[path], mesh)
               * np.dtype(dtype_of(leaf)).itemsize for path, leaf in leaves)


def _jax_inputs(cfg, cell) -> dict:
    """{input: (shape, logical axes)} of the JAX dry run's
    ``input_specs`` / ``batch_logical_axes`` for the cell, every one 4
    bytes an element (int32 tokens, f32 frames, patches and memory)."""
    b, s, d = cell.global_batch, cell.seq_len, cfg.d_model
    rows = ("batch", None, None)
    if cell.kind == "decode":
        out = {"tokens": ((b, 1), ("batch", None))}
        if cfg.is_encoder_decoder:
            out["memory"] = ((b, jshapes.ENCDEC_DECODE_MEMORY_LEN, d), rows)
        return out
    vision = cfg.frontend == "vision"
    s_text = s - (cfg.frontend_len if vision else 0)
    names = ("inputs", "targets") if cell.kind == "train" else ("tokens",)
    out = {n: ((b, s_text), ("batch", None)) for n in names}
    if vision:
        out["frontend_embeds"] = ((b, cfg.frontend_len, d), rows)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = ((b, s, d), rows)
    return out


def _jax_bytes(arch, shape, mesh) -> dict:
    """Each rank's bytes implied by the JAX package's placements."""
    cell = jshapes.SHAPES[shape]
    train = cell.kind == "train"
    params = _jax_params(arch, not train)
    n_params = sum(math.prod(x.shape) for x in jax.tree.leaves(params))
    profile = "dp" if n_params < 2_000_000_000 else "tp"
    act = jsh.make_activation_rules(profile)
    compute = jsh.param_specs(params, mesh,
                              jsh.make_param_rules(False, profile))
    out = {"profile": profile, "n_params": n_params}
    if train:
        fsdp = jsh.param_specs(params, mesh,
                               jsh.make_param_rules(True, profile))
        out["param_bytes"] = _tree_bytes(
            params, compute, mesh,
            lambda leaf: (jnp.bfloat16 if leaf.ndim >= 2
                          and leaf.dtype == jnp.float32 else leaf.dtype))
        out["master_bytes"] = _tree_bytes(params, fsdp, mesh)
    else:
        out["param_bytes"] = _tree_bytes(params, compute, mesh)
    b, s = cell.global_batch, cell.seq_len
    cfg = _cell_cfg(jax_get_config(arch), cell.kind)
    out["input_bytes"] = sum(
        _local(sh, jsh.spec_for(sh, axes, mesh, act), mesh) * 4
        for sh, axes in _jax_inputs(cfg, cell).values())
    if cell.kind == "decode":
        cache = jax.eval_shape(lambda: jax_init_cache(cfg, b, s))
        specs = jsh.tree_specs(cache, jax_cache_axes(cfg), mesh, act)
        out["cache_bytes"] = sum(_local(cache[k].shape, specs[k], mesh)
                                 * np.dtype(cache[k].dtype).itemsize
                                 for k in cache)
        out["input_bytes"] += 4                             # pos
    return out


@pytest.mark.parametrize("mesh_tag", list(MESHES))
@pytest.mark.parametrize("arch", PLACED)
def test_per_rank_bytes_equal_the_jax_placements(arch, mesh_tag):
    _check_cells(arch, MESHES[mesh_tag])


def _check_cells(arch, multi):
    """Each of ``arch``'s cells on the production mesh: the record's bytes
    equal those the JAX package's placements imply."""
    stand_in = PlacementMesh(**make_production_mesh(multi_pod=multi).shape)
    for shape in shapes.cells_for(get_config(arch)):
        rec = dryrun.lower_cell(arch, shape, multi_pod=multi, verbose=False)
        want = _jax_bytes(arch, shape, stand_in)
        assert rec["profile"] == want["profile"]
        assert rec["n_params"] == want["n_params"]
        assert rec["param_bytes"] == want["param_bytes"], shape
        assert rec["input_bytes"] == want["input_bytes"], shape
        if shape == "train_4k":
            assert rec["master_bytes"] == want["master_bytes"]
            assert rec["moment_bytes"] == 2 * want["master_bytes"]
            assert rec["state_bytes"] == (want["param_bytes"]
                                          + 3 * want["master_bytes"])
        if SHAPES_KIND[shape] == "decode":      # decode_32k, long_500k
            assert rec["cache_bytes"] == want["cache_bytes"], shape
        assert rec["arg_bytes"] == (rec["state_bytes"]
                                    + rec["opt_scalar_bytes"]
                                    + rec["cache_bytes"]
                                    + rec["input_bytes"])
        assert set(rec["absent"]) == set(dryrun.ABSENT)


@pytest.mark.parametrize("arch", list(REFUSED))
def test_refused_families_raise_with_their_item_number(arch):
    """The encoder-decoder and vision families, which the dry run refused
    until their mesh path landed, are placed at each of their three cells
    on both production meshes, their frames, memory and patches
    included."""
    cfg = get_config(arch)
    assert cfg.family == REFUSED[arch]
    assert shapes.cells_for(cfg) == ["train_4k", "prefill_32k", "decode_32k"]
    for multi in MESHES.values():
        _check_cells(arch, multi)
    rec = dryrun.lower_cell(arch, "decode_32k", verbose=False)
    assert rec["profile"] == ("dp" if arch == "seamless_m4t_medium"
                              else "tp")


def test_all_writes_a_record_a_placed_cell(tmp_path, capsys):
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    want = sorted(f"{a}__{s}__single.json" for a in PLACED + list(REFUSED)
                  for s in shapes.cells_for(get_config(a)))
    assert len(want) == 32 and files == want
    for name in files:
        rec = json.loads((tmp_path / name).read_text())
        assert rec["arg_bytes"] > 0 and rec["model_flops"] > 0
    out = capsys.readouterr().out
    assert "32 cells placed" in out and "refused" not in out
