"""Placement dry run: each rank's bytes and the model FLOPs for every
(arch x shape cell x production mesh), with no device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell with
XLA and reads ``memory_analysis`` / ``cost_analysis``.  The port has no
compiler to ask, so a cell here is placement arithmetic:

  1. the production mesh as placements (``launch.mesh.make_production_
     mesh``: a shape, no processes);
  2. the cell's parameters built under ``FakeTensorMode`` (no memory):
     f32 masters for a train cell, int8-quantized for a serving cell (the
     experts too for MoE), as the JAX package's ``params_shape_for``;
  3. the parallelism profile (``dp`` under 2B parameters, else ``tp``)
     and each rank's share by ``param_specs`` / ``tree_specs``: a train
     cell's bf16 compute copy by the compute rules, its f32 master and
     AdamW moments by the FSDP rules (ZeRO-1, as ``bridge.
     shard_train_state`` places them), a serving cell's weights by the
     serving rules, a decode cell's dense cache by ``cache_logical_axes``,
     the inputs by the activation rules;
  4. the record: ``n_params``, ``profile``, ``quant``, the per-rank bytes
     of the parameters, the optimizer state, the cache and the inputs
     (their sum, ``arg_bytes``, is the counterpart of the JAX record's),
     and ``model_flops`` (``roofline/model_flops.py``).

What only a compiler gives (temporaries, output and code bytes, HLO FLOPs,
collective bytes, the roofline fraction) is absent and listed so in each
record (``ABSENT``); the roofline itself is ROADMAP queue 1, item 15.
The dense, MoE, SSM and hybrid families are placed.  An MoE cell's expert
stacks follow
the same rules: int8 in a serving cell, on ``model`` by expert where the
count divides it (qwen3-moe's 128 on 16) or else by ``expert_mlp``
(granite's 40); a train cell's master and moments split over ``data``
by expert and over ``model`` by ``expert_mlp`` (the FSDP rules), which
``bridge.shard_train_state`` reaches from the E-split compute copy
through the whole tensor (``launch.sharding.TrainPlacement.relayout``).
mamba2-370m (under 2 B parameters: ``dp``, its weights replicated over
``model`` and the batch over every axis it divides) and zamba2-7b
(``tp``: ``in_z`` / ``in_x`` / ``conv_x`` by ``ssm_inner``, ``out_proj``
by its rows) are placed at all four of their cells, ``long_500k``
included; a serving cell's cache is the slot state (``ssm_h`` by
``ssm_heads``, ``conv_x`` by ``ssm_inner``) and zamba2's 13 shared-site
KV caches (by KV heads).  seamless-m4t-medium (under 2 B parameters:
``dp``) and phi-3-vision (``tp``) are placed at their three cells: the
encoder's layers and the decoder's cross projections by the decoder
blocks' rules, the encoder's frames, a decode cell's encoded memory and
the vision family's patches by their batch axis (``input_shapes``).
``--all`` places every cell of every architecture, 32 on the
production meshes.

Usage (no card):
  python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape train_4k \
      [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import tempfile

import torch

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (ENCDEC_DECODE_MEMORY_LEN, SHAPES,
                                       ShapeCell, cells_for)
from repro_torch.launch.sharding import (BATCH_AXES, local_shape,
                                         make_activation_rules,
                                         make_param_rules, param_specs,
                                         spec_for, tree_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.roofline.model_flops import model_flops
from repro_torch.tree import is_stacked

# keys of the JAX package's record that only its compiler can fill
ABSENT = ("temp_bytes", "output_bytes", "code_bytes", "hlo_flops",
          "hlo_bytes", "coll_bytes", "roofline_fraction", "bound",
          "lower_s", "compile_s")
# the scalars of a train step's arguments: AdamW's count and the step
TRAIN_SCALAR_BYTES = 4 + 4
# a decode step's position argument
DECODE_SCALAR_BYTES = 4


@contextlib.contextmanager
def _fake():
    """``FakeTensorMode`` with the truncated-normal initialiser (which
    reads a value) left out: shapes and dtypes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    saved = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *a, **k: t
    try:
        with FakeTensorMode():
            yield
    finally:
        torch.nn.init.trunc_normal_ = saved


@functools.lru_cache(maxsize=None)
def params_shape_for(cfg: ModelConfig, *, quantized: bool) -> dict:
    """{tensor name: (shape, dtype)} of ``cfg``'s model at full size,
    int8-quantized (experts too for MoE) when ``quantized`` (cached: do not
    change the dict)."""
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    with _fake():
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        if quantized:
            model = quantize_model_params(model, in_place=True,
                                          quantize_experts=cfg.is_moe)
        return {n: (tuple(t.shape), t.dtype)
                for n, t in model.named_buffers()}


def cache_shape_for(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{array: (shape, dtype)} of the dense bf16 decode cache."""
    from repro_torch.serving.cache import init_cache
    with _fake():
        cache = init_cache(cfg, batch, max_len, torch.bfloat16,
                           device="cpu")
        return {k: (tuple(v.shape), v.dtype) for k, v in cache.items()
                if torch.is_tensor(v)}


def input_shapes(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """{input: (shape, dtype)} of the cell's step (the cache aside), as the
    JAX package's ``input_specs``: the vision family's text is the cell's
    length less its ``frontend_len`` patches, which come as f32
    ``frontend_embeds``; an encoder-decoder's train and prefill cells take
    the cell's length of f32 ``encoder_frames``, its decode cells an f32
    ``memory`` of ``ENCDEC_DECODE_MEMORY_LEN`` rows."""
    b, s, d = cell.global_batch, cell.seq_len, cfg.d_model
    f32, i32 = torch.float32, torch.int32
    if cell.kind == "decode":
        out = {"tokens": ((b, 1), i32)}
        if cfg.is_encoder_decoder:
            out["memory"] = ((b, ENCDEC_DECODE_MEMORY_LEN, d), f32)
        return out
    vision = cfg.frontend == "vision"
    s_text = s - (cfg.frontend_len if vision else 0)
    out = ({"inputs": ((b, s_text), i32), "targets": ((b, s_text), i32)}
           if cell.kind == "train" else {"tokens": ((b, s_text), i32)})
    if vision:
        out["frontend_embeds"] = ((b, cfg.frontend_len, d), f32)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = ((b, s, d), f32)
    return out


def _bytes(shape, dtype, spec, mesh) -> int:
    return math.prod(local_shape(shape, spec, mesh)) * dtype.itemsize


def place_cell(cfg: ModelConfig, cell: ShapeCell, mesh, *,
               quant: str = "w8a8") -> dict:
    """The record of ``cfg`` at ``cell`` on ``mesh`` (anything with a
    ``shape``): module docstring, step 4."""
    train = cell.kind == "train"
    if train:
        cfg = cfg.replace(quant_proj="none", dtype="bfloat16")
    else:
        cfg = cfg.replace(quant_proj=quant, dtype="bfloat16")
    quantized = not train and quant != "none"
    params = params_shape_for(cfg, quantized=quantized)
    shapes = {n: s for n, (s, _) in params.items()}
    n_params = sum(math.prod(s) for s in shapes.values())
    profile = cfg.parallelism
    if profile == "auto":
        profile = "dp" if n_params < 2_000_000_000 else "tp"
    act_rules = make_activation_rules(profile)
    rec = {"arch": cfg.name, "shape": cell.name, "kind": cell.kind,
           "mesh": dict(mesh.shape), "chips": math.prod(mesh.shape.values()),
           "profile": profile, "n_params": n_params,
           "quant": quant if not train else "none"}
    compute = param_specs(shapes, mesh, make_param_rules(False, profile))
    if train:
        fsdp = param_specs(shapes, mesh, make_param_rules(True, profile))
        # the compute copy casts a leaf whose JAX leaf has >= 2 dims to bf16
        param_bytes = sum(
            _bytes(s, torch.bfloat16 if len(s) + is_stacked(n) >= 2
                   else torch.float32, compute[n], mesh)
            for n, s in shapes.items())
        master = sum(_bytes(s, torch.float32, fsdp[n], mesh)
                     for n, s in shapes.items())
        rec.update(param_bytes=param_bytes, master_bytes=master,
                   moment_bytes=2 * master,
                   state_bytes=param_bytes + 3 * master,
                   opt_scalar_bytes=TRAIN_SCALAR_BYTES)
    else:
        param_bytes = sum(_bytes(s, dt, compute[n], mesh)
                          for n, (s, dt) in params.items())
        rec.update(param_bytes=param_bytes, state_bytes=param_bytes,
                   opt_scalar_bytes=0)
    inputs = input_shapes(cfg, cell)
    rec["input_bytes"] = sum(
        _bytes(s, dt, spec_for(s, BATCH_AXES[k], mesh, act_rules), mesh)
        for k, (s, dt) in inputs.items())
    rec["cache_bytes"] = 0
    if cell.kind == "decode":
        from repro_torch.serving.cache import cache_logical_axes
        cache = cache_shape_for(cfg, cell.global_batch, cell.seq_len)
        axes = cache_logical_axes(cfg)
        specs = tree_specs({k: s for k, (s, _) in cache.items()}, axes,
                           mesh, act_rules)
        rec["cache_bytes"] = sum(_bytes(s, dt, specs[k], mesh)
                                 for k, (s, dt) in cache.items())
        rec["input_bytes"] += DECODE_SCALAR_BYTES
    rec["arg_bytes"] = (rec["state_bytes"] + rec["opt_scalar_bytes"]
                        + rec["cache_bytes"] + rec["input_bytes"])
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    rec["tokens"] = tokens
    rec["model_flops"] = model_flops(cfg, shapes, kind=cell.kind,
                                     tokens=tokens, kv_len=cell.seq_len,
                                     batch=cell.global_batch)
    rec["absent"] = {k: "needs a compiler (ROADMAP queue 1, item 15)"
                     for k in ABSENT}
    return rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               quant: str = "w8a8", verbose: bool = True) -> dict:
    """The JAX package's ``lower_cell`` as placements: ``arch`` at
    ``shape_name`` on the production mesh."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = place_cell(cfg, SHAPES[shape_name], mesh, quant=quant)
    rec["arch"] = arch
    if verbose:
        mesh_name = "x".join(str(n) for n in mesh.shape.values())
        print(f"[{arch} x {shape_name} x {mesh_name}] {rec['profile']}  "
              f"params {rec['param_bytes'] / 2**30:.2f}GiB  state "
              f"{rec['state_bytes'] / 2**30:.2f}GiB  cache "
              f"{rec['cache_bytes'] / 2**30:.2f}GiB  args "
              f"{rec['arg_bytes'] / 2**30:.2f}GiB a rank  model_flops "
              f"{rec['model_flops']:.3e}", flush=True)
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ARCHITECTURES, get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant", default="w8a8",
                    choices=["none", "w8", "w8a8"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_dryrun"))
    args = ap.parse_args(argv)
    if args.all:
        todo = [(arch, shape) for arch in ARCHITECTURES
                if arch != "distilbert_paper"
                for shape in cells_for(get_config(arch))]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    tag = "multi" if args.multi_pod else "single"
    failures, done = [], 0
    for arch, shape in todo:
        try:
            rec = lower_cell(arch, shape, multi_pod=args.multi_pod,
                             quant=args.quant)
        except Exception as e:  # noqa: BLE001 — report and continue sweep
            failures.append((arch, shape, repr(e)))
            print(f"[{arch} x {shape}] FAILED: {e!r}")
            continue
        with open(os.path.join(args.out, f"{arch}__{shape}__{tag}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
        done += 1
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"\n{done} cells placed; records in "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
