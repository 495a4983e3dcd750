"""Rank programs for the encoder-decoder, vision and sequence-split mesh
tests (``tests/test_torch_encdec_mesh.py``): each runs in a process that
``launch.mesh.spawn_ranks`` starts (over gloo), on its mesh's device, and
imports neither JAX nor the JAX package (the test process holds those)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, shard_model
from repro_torch.models.attention import apply_attention
from repro_torch.models.transformer import encode
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import greedy_decode, prefill, prefill_step


def _cpu(t):
    return t.detach().float().cpu().clone()


def _padded(prompts):
    lens = torch.tensor([len(p) for p in prompts])
    padded = torch.zeros((len(prompts), int(lens.max())), dtype=torch.long)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.as_tensor(np.asarray(p))
    return padded, lens


def mesh_programs(mesh, programs):
    """Each of ``programs`` ({key: (name of a program here, its arguments
    after the mesh)}) in turn, in one spawn."""
    return {key: globals()[name](mesh, *args)
            for key, (name, args) in programs.items()}


def _serve(model, cfg, prompts, steps, config, dev, memory=None):
    """``prefill`` → ``greedy_decode`` of ``prompts`` on a cache built with
    ``config``: first logits, tokens, the cache's policy and its shapes."""
    padded, lens = _padded(prompts)
    cache = init_cache(cfg, len(prompts), int(lens.max()) + steps + 4,
                       torch.float32, config, device=dev)
    out = {"kv_shard": cache.get("kv_shard"),
           "shapes": {k: tuple(v.shape) for k, v in cache.items()
                      if torch.is_tensor(v)}}
    logits, cache = prefill(model, cache, padded.to(dev), lens.to(dev), cfg,
                            memory=memory)
    pos = None if "seq_lens" in cache else lens.to(dev)
    toks, cache = greedy_decode(model, cache, logits.argmax(-1)[:, None],
                                pos, steps, cfg, memory=memory)
    out.update(logits=_cpu(logits), tokens=toks.cpu())
    return out


def encdec_rank(mesh, tree, cfg, frames, x, prompts, steps, cache_kw):
    """seamless on this rank: the unsharded model first (its memory and
    layer 1's cross-attention of ``x`` to it), then the rank's shard
    (``shard_model``): the memory, the same cross-attention, and
    ``prefill`` → ``greedy_decode`` with ``memory=`` on a cache of the
    mesh (``cache_kw``)."""
    dev = mesh.device
    frames, x = frames.to(dev), x.to(dev)
    pos = torch.arange(x.shape[1], device=dev)
    model = params_from_numpy(tree, cfg, device=dev)
    out = {}
    with torch.inference_mode():
        for tag in ("ref", "got"):
            if tag == "got":
                shard_model(model, mesh)
            mem = encode(model, frames, cfg)
            cross, _ = apply_attention(model.layers[1].cross, x, cfg,
                                       positions=pos, memory=mem)
            out[f"{tag}_memory"], out[f"{tag}_cross"] = _cpu(mem), _cpu(cross)
        out["serve"] = _serve(model, cfg, prompts, steps,
                              CacheConfig(**cache_kw, mesh=mesh), dev,
                              memory=mem)
    wq = model.layers[1].cross.wq
    out["wq_cols"] = tuple((wq.w if wq.w is not None
                            else wq.w_q_values).shape)
    out["enc_wo"] = model.encoder.layers[0].attn.wo.shard
    out["embed"] = model.embed.shard
    return out


def vlm_rank(mesh, tree, cfg, tokens, patches):
    """phi3's ``prefill_step(frontend_embeds=)`` on the rank's shard."""
    dev = mesh.device
    model = shard_model(params_from_numpy(tree, cfg, device=dev), mesh)
    with torch.inference_mode():
        logits, _ = prefill_step(model, tokens.to(dev), cfg,
                                 frontend_embeds=patches.to(dev))
    return _cpu(logits)


def seq_split_rank(mesh, tree, cfg, prompts, steps, unsharded=False):
    """``prefill`` → ``greedy_decode`` on a dense cache of the mesh (its KV
    heads do not divide the mesh: split by sequence); with ``unsharded``,
    the same serve of the unsharded model on this rank first (mesh 1)."""
    dev = mesh.device
    model = params_from_numpy(tree, cfg, device=dev)
    out = {}
    with torch.inference_mode():
        if unsharded:
            out["mesh1"] = _serve(model, cfg, prompts, steps, CacheConfig(),
                                  dev)
        shard_model(model, mesh)
        out.update(_serve(model, cfg, prompts, steps,
                          CacheConfig(mesh=mesh), dev))
    return out


def _plain_w8a8():
    """(module, {name: plain version}) of every K1 / K2 mode the w8a8
    projections call (``core/quantized_linear.py``), on whatever device
    their tensors are."""
    from repro_torch.core import quantized_linear as ql
    from repro_torch.core.quantization import QTensor
    from repro_torch.kernels.quant_act import ref as qref
    from repro_torch.kernels.tiled_matmul import ref as mref

    def quant_act(x, *, absmax=None):
        values, scale = qref.quant_act_ref(x, absmax=absmax)
        return QTensor(values=values, scale=scale, bits=8)

    def tiled_matmul(a, b, bias=None, *, out_dtype=torch.bfloat16):
        return mref.tiled_matmul_ref(a.values, a.scale, b.values, b.scale,
                                     bias, out_dtype)

    def int8_epilogue(acc, a_scale, b, bias=None, *,
                      out_dtype=torch.bfloat16):
        return mref.int8_epilogue_ref(acc, a_scale, b.scale, bias, out_dtype)

    return ql, {"quant_act": quant_act, "row_absmax": qref.row_absmax_ref,
                "tiled_matmul": tiled_matmul,
                "tiled_matmul_int32": lambda a, b: mref.int_matmul_exact(
                    a.values, b.values),
                "int8_epilogue": int8_epilogue}


def _on_plain(fn):
    """``fn()`` with the w8a8 projections on the plain versions."""
    ql, plain = _plain_w8a8()
    saved = {name: getattr(ql, name) for name in plain}
    for name, f in plain.items():
        setattr(ql, name, f)
    try:
        return fn()
    finally:
        for name, f in saved.items():
            setattr(ql, name, f)


def cross_card_rank(mesh, tree, cfg, x, memory):
    """Layer 1's cross-attention on the card: unsharded on the plain
    versions first (mesh 1), then on the rank's heads through the kernels
    (with the launch counts) and on the plain versions."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = mesh.device
    x, memory = x.to(dev), memory.to(dev)
    pos = torch.arange(x.shape[1], device=dev)
    model = params_from_numpy(tree, cfg, device=dev)

    def cross():
        y, _ = apply_attention(model.layers[1].cross, x, cfg, positions=pos,
                               memory=memory)
        return y

    with torch.inference_mode():
        ref = _on_plain(cross)
        shard_model(model, mesh)
        reset_launch_counts()
        got = cross()
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        plain = _on_plain(cross)
    return {"got": _cpu(got), "plain": _cpu(plain), "ref": _cpu(ref),
            "counts": counts, "finite": bool(torch.isfinite(got).all())}
