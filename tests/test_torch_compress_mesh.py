"""int8 gradient compression over a ``("data", "model")`` mesh
(``runtime/compression.py`` with ``mesh=`` / ``specs=``, the train step's
compressor hook) on the CPU, over gloo ranks; the rank programs are in
``tests/_torch_compress_ranks.py``.

The JAX package compresses the global gradient (its compressor on the
reduced gradient, before AdamW).  So a rank's compressor outputs are held
bitwise to its blocks of the port's single-device compressor run on the
whole reduced gradients and residuals, gathered here from every rank's
blocks, with the same seed (both rounding modes): the scale is each
leaf's absmax over every rank, and the noise is drawn at the whole
leaf's shape.  On (data 1, model 2) a compressor that scaled by the
rank's own block gave about one quantum of difference on most leaves.
Also per rank: the new residual is exactly what the wire did not carry
(``tests/test_torch_runtime.py``'s error-feedback rule).

Meshes (2, 1), (1, 2) and (2, 2), qwen2.5-3b's smoke config in f32 (the
classic layout) and bf16 (ZeRO-1); on (2, 2) also qwen3-moe (expert-split
and ``relayout`` leaves), zamba2-7b (``ssm_heads`` / ``ssm_inner`` and
``partial`` leaves), seamless (the encoder and cross-attention) and
phi-3-vision in bf16.  Every case runs 2 steps (3 for the JAX case) of
SyntheticLM batches of 2 x 64 tokens (the smoke threshold: K5's route, on
its plain version).  The (2, 2) f32 deterministic steps are held to the
JAX package's single-device compressed steps at
``test_train_steps_with_compressor_match_jax``'s limits, and the launcher
on (2, 2) to its one-device compressed run within ``BF16_LOSS``.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.compression import GradCompressor as JaxCompressor
from repro.training.train_step import TrainState as JaxState
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.launch.sharding import entry_axes, take_shard
from repro_torch.runtime.compression import GradCompressor
from test_torch_bridge import numpy_tree, paired_models

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_compress_ranks as ranks  # noqa: E402

ARCH = "qwen2_5_3b"
FAMILIES = ("qwen3_moe_30b_a3b", "zamba2_7b", "seamless_m4t_medium",
            "phi3_vision_4_2b")
MESHES = [(2, 1), (1, 2), (2, 2)]
DTYPES = ("float32", "bfloat16")
MODES = ("deterministic", "stochastic")
BATCH, SEQ, STEPS, JAX_STEPS = 2, 64, 2, 3
RANK_TIMEOUT = 120
BF16_LOSS = 1e-3


def _rank_mesh(data, model, g):
    """Rank ``g``'s view of a (data, model) mesh, for placements only."""
    d, m = divmod(g, model)
    return Mesh(model, m, data=data, data_rank=d, device="cpu",
                axis_names=("data", "model"))


@functools.lru_cache(maxsize=None)
def _qwen():
    """The JAX package's f32 qwen2.5-3b smoke params, as numpy and torch
    configs."""
    jcfg, params, tcfg, _ = paired_models(ARCH, dtype="float32")
    return jcfg, params, tcfg, numpy_tree(params)


@functools.lru_cache(maxsize=None)
def _spawn(data, model):
    """One spawn of the mesh: qwen2.5-3b in both dtypes and both modes; on
    (2, 2) the other families in bf16, both modes."""
    _, _, tcfg, tree = _qwen()
    cases = {}
    for dtype in DTYPES:
        for mode in MODES:
            steps = (JAX_STEPS if (data, model, dtype, mode)
                     == (2, 2, "float32", "deterministic") else STEPS)
            cases[(ARCH, dtype, mode)] = (
                tcfg.replace(dtype=dtype), tree, mode == "stochastic",
                steps, BATCH, SEQ)
    if (data, model) == (2, 2):
        for arch in FAMILIES:
            cfg = get_smoke_config(arch)
            for mode in MODES:
                cases[(arch, cfg.dtype, mode)] = (
                    cfg, None, mode == "stochastic", STEPS, BATCH, SEQ)
    return spawn_ranks(ranks.compress_rank, data * model, data=data,
                       backend="gloo", device="cpu", args=(cases,),
                       timeout=RANK_TIMEOUT)


def _assemble(blocks, spec, data, model):
    """The whole tensor from every rank's block placed by ``spec``; every
    rank's block must be its block of it (replicated blocks equal)."""
    meshes = [_rank_mesh(data, model, g) for g in range(len(blocks))]
    shape = [n * meshes[0].extent(entry_axes(e)) if entry_axes(e) else n
             for n, e in zip(blocks[0].shape, spec)]
    whole = torch.empty(shape, dtype=blocks[0].dtype)
    for mesh, b in zip(meshes, blocks):
        take_shard(whole, spec, mesh).copy_(b)
    for mesh, b in zip(meshes, blocks):
        assert torch.equal(take_shard(whole, spec, mesh), b), spec
    return whole


def _check_bitwise(runs, key, data, model):
    """Each step's wire and residual blocks on every rank against the
    single-device compressor on the whole gradients and residuals, with
    one generator of the same seed carried across the steps; returns the
    number of leaves checked a step."""
    cases = [r[key] for r in runs]
    specs = cases[0]["specs"]
    gc = GradCompressor(stochastic=key[2] == "stochastic")
    gen = torch.Generator().manual_seed(ranks.SEED)
    meshes = [_rank_mesh(data, model, g) for g in range(len(runs))]
    for i in range(len(cases[0]["steps"])):
        steps = [c["steps"][i] for c in cases]
        whole = {part: {n: _assemble([s[part][n] for s in steps], specs[n],
                                     data, model)
                        for n in specs}
                 for part in ("g", "r")}
        wire, res = gc.compress_decompress(whole["g"], whole["r"], gen)
        for g, (mesh, s) in enumerate(zip(meshes, steps)):
            assert s["wire"].keys() == s["res"].keys() == specs.keys()
            for n, spec in specs.items():
                assert torch.equal(s["wire"][n],
                                   take_shard(wire[n], spec, mesh)), \
                    (key, i, g, n)
                assert torch.equal(s["res"][n],
                                   take_shard(res[n], spec, mesh)), \
                    (key, i, g, n)
    return len(specs)


def test_model_axis_scales_by_the_whole_leaf():
    """(data 1, model 2), f32, deterministic rounding: every leaf's wire
    and residual blocks bitwise the single-device compressor's on the
    gathered reduced gradients, where some split leaves' blocks hold
    smaller maxima than the whole leaf (a rank's own absmax would scale
    them otherwise)."""
    runs = _spawn(1, 2)
    key = (ARCH, "float32", "deterministic")
    assert _check_bitwise(runs, key, 1, 2) > 30
    specs = runs[0][key]["specs"]
    first = [r[key]["steps"][0] for r in runs]
    split = [n for n, spec in specs.items()
             if any("model" in entry_axes(e) for e in spec)]
    assert split
    smaller = [n for n in split
               if min(float((s["g"][n] + s["r"][n]).abs().max())
                      for s in first)
               < max(float((s["g"][n] + s["r"][n]).abs().max())
                     for s in first)]
    assert smaller


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("data,model", MESHES)
def test_rank_blocks_are_the_single_device_compressors(data, model, dtype,
                                                       mode):
    runs = _spawn(data, model)
    key = (ARCH, dtype, mode)
    _check_bitwise(runs, key, data, model)
    # the state really is split over each axis of more than one rank
    specs = runs[0][key]["specs"]
    for axis, n in (("data", data), ("model", model)):
        if n > 1 and (axis == "model" or dtype == "bfloat16"):
            assert any(axis in entry_axes(e) for s in specs.values()
                       for e in s), axis


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_on_2x2_zero1(arch, mode):
    runs = _spawn(2, 2)
    key = (arch, "bfloat16", mode)
    _check_bitwise(runs, key, 2, 2)
    case = runs[0][key]
    specs = case["specs"]
    if arch == "qwen3_moe_30b_a3b":
        assert case["relayout"]
        assert any(".experts." in n and any("model" in entry_axes(e)
                                            for e in s)
                   for n, s in specs.items())
    if arch == "zamba2_7b":
        assert any(".mamba." in n for n in case["partial"])
        assert specs["layers.0.mamba.in_x.w"][-1] == "model"
    if arch == "seamless_m4t_medium":
        assert any(n.startswith("encoder.") for n in specs)
        assert any(".cross." in n for n in specs)
    for r in runs:
        assert all(torch.isfinite(torch.tensor(m["loss"]))
                   for m in r[key]["metrics"])


@pytest.mark.parametrize("data,model", MESHES)
def test_residual_is_what_the_wire_did_not_carry(data, model):
    for r in _spawn(data, model):
        for key, case in r.items():
            for s in case["steps"]:
                for n, wire in s["wire"].items():
                    x = s["g"][n].float() + s["r"][n]
                    assert wire.dtype == torch.float32, (key, n)
                    assert torch.equal(s["res"][n], x - wire), (key, n)


@functools.lru_cache(maxsize=None)
def _jax_compressed_steps():
    """The JAX package's single-device f32 steps with its compressor
    (deterministic rounding), as ``tests/test_torch_training.py`` runs
    them: each step's metrics."""
    jcfg, params, _, _ = _qwen()
    jgc = JaxCompressor(stochastic=False)
    res = {"r": jgc.init_residual(params)}

    def comp(grads):
        wire, res["r"] = jgc.compress_decompress(grads, res["r"],
                                                 jax.random.PRNGKey(7))
        return wire

    opt = JaxAdamW(learning_rate=jax_warmup_cosine(1e-3, 2, 10))
    step = jax.jit(jax_train_step(jcfg, opt, compressor=comp))
    state = JaxState.create(params, opt)
    data = JaxLM(jcfg.vocab_size, BATCH, SEQ, seed=0)
    out = []
    for i in range(JAX_STEPS):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch_at(i).items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_2x2_compressed_steps_match_the_jax_single_device_steps():
    want = _jax_compressed_steps()
    for r in _spawn(2, 2):
        got = r[(ARCH, "float32", "deterministic")]["metrics"]
        assert len(got) == len(want) == JAX_STEPS
        for i, (tm, jm) in enumerate(zip(got, want)):
            loss_tol, norm_tol = (1e-5, 1e-4) if i == 0 else (1e-4, 1e-2)
            assert abs(tm["loss"] - jm["loss"]) <= loss_tol * abs(jm["loss"])
            assert abs(tm["grad_norm"] - jm["grad_norm"]) \
                <= norm_tol * jm["grad_norm"], i


def test_launcher_compresses_on_a_2x2_mesh(tmp_path):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "64", "--ckpt-every", "3",
            "--compress-grads"]
    history = launcher.main(args + ["--data-par", "2", "--model-par", "2",
                                    "--backend", "gloo", "--ckpt-dir",
                                    str(tmp_path / "mesh")])
    one = launcher.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    (step, got), (_, want) = history[-1], one[-1]
    assert step == 3
    assert abs(got["loss"] - want["loss"]) <= BF16_LOSS * abs(want["loss"])


def test_placements_that_do_not_fit_the_gradients_raise():
    """Checked before any collective, so a mesh without process groups
    serves."""
    mesh = _rank_mesh(2, 2, 0)
    grads = {"layers.0.attn.wq.w": torch.ones(4, 2),
             "final_norm.scale": torch.ones(4)}
    res = GradCompressor().init_residual(grads)
    gc = GradCompressor(stochastic=False)
    specs = {"layers.0.attn.wq.w": ("data", "model"),
             "final_norm.scale": (None,)}
    for bad in ({"layers.0.attn.wq.w": ("data", "model")},
                {**specs, "final_norm.scale": (None, None)},
                {**specs, "final_norm.scale": ("pod",)}):
        with pytest.raises(ValueError):
            gc.compress_decompress(grads, res, mesh=mesh, specs=bad)
    with pytest.raises(ValueError, match="specs="):
        gc.compress_decompress(grads, res, mesh=mesh)
    with pytest.raises(ValueError, match="without a mesh"):
        gc.compress_decompress(grads, res, specs=specs)
    # one rank: the single-device compressor
    one = Mesh(1, device="cpu", axis_names=("data", "model"))
    got = gc.compress_decompress(grads, res, mesh=one,
                                 specs={n: (None,) * g.dim()
                                        for n, g in grads.items()})
    want = gc.compress_decompress(grads, res)
    for a, b in zip(got, want):
        assert all(torch.equal(a[n], b[n]) for n in grads)
