"""Rank programs for the port's mesh tests: each runs in a process that
``launch.mesh.spawn_ranks`` starts (over gloo), on its mesh's device, and
imports neither JAX nor the JAX package (the test process holds those)."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, shard_model
from repro_torch.core.qkv_fusion import apply_fused_qkv
from repro_torch.core.quantized_linear import (apply_linear_swiglu,
                                               apply_linears)
from repro_torch.models.attention import _project_out
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.scheduler import Scheduler, SpecConfig


def sched_trace(mesh, tree, cfg, trace, cache_kw, sched_kw, draft_layers=0):
    """Serve ``trace`` — [(tick, prompt, budget), ...], each request
    submitted before the tick it names — through a Scheduler on this
    rank's shard; returns the generated tokens in submission order, the
    tokens emitted at each tick, the per-shard occupancy log, the policy,
    this rank's cache shapes and whether a ``spec=`` (a draft of the
    first ``draft_layers`` layers, if any) was honoured or degraded."""
    model = shard_model(params_from_numpy(tree, cfg, device=mesh.device),
                        mesh)
    config = CacheConfig(mesh=mesh, **cache_kw)
    spec = None
    if draft_layers:
        draft = params_from_numpy(tree, cfg, device=mesh.device)
        draft.layers = draft.layers[:draft_layers]
        spec = SpecConfig(draft, cfg.replace(n_layers=draft_layers), 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sched = Scheduler(model, cfg, config=config, device=mesh.device,
                          spec=spec, **sched_kw)
    rids, ticks, tick = [], [], 0
    pending = sorted(trace, key=lambda r: r[0])
    with torch.inference_mode():
        while pending or sched.queue or sched.n_active:
            while pending and pending[0][0] <= tick:
                _, prompt, budget = pending.pop(0)
                rids.append(sched.submit(np.asarray(prompt), budget))
            sched.step()
            ticks.append([s.last_token if s else -1 for s in sched.slots])
            tick += 1
            if tick > 200:
                raise RuntimeError("the trace did not drain")
    return {"tokens": [sched.finished[r] for r in rids], "ticks": ticks,
            "per_shard": sched.shard_occupancy_log,
            "policy": config.resolved_kv_shard(cfg.n_kv_heads),
            "shapes": {k: tuple(v.shape) for k, v in sched.cache.items()
                       if torch.is_tensor(v)},
            "kv_shard": sched.cache.get("kv_shard"),
            "spec": sched.spec is not None,
            "warnings": [str(w.message) for w in caught]}


def layer_projections(mesh, tree, cfg, x, o_in):
    """Layer 0's seven projections on ``x`` (M, D) and the attention output
    ``o_in`` (M, q_dim), as the rank's forward computes them, then whole:
    the column outputs (q, k, v, gate, up) gathered over the mesh, the
    row-parallel ones (wo, down) after their reduction."""
    model = shard_model(params_from_numpy(tree, cfg, device=mesh.device),
                        mesh)
    attn, ffn = model.layers[0].attn, model.layers[0].ffn
    x = torch.as_tensor(x, device=mesh.device)
    o_in = torch.as_tensor(o_in, device=mesh.device)
    mode = cfg.quant_proj

    def whole(t, lin):
        return mesh.all_gather(t, dim=-1) if lin.shard == "column" else t

    with torch.inference_mode():
        q, k, v = apply_fused_qkv(attn.wq, attn.wk, attn.wv, x, mode=mode)
        gate, up = apply_linears((ffn.gate, ffn.up), x, mode=mode)
        out = {"q": whole(q, attn.wq), "k": whole(k, attn.wk),
               "v": whole(v, attn.wv),
               "wo": _project_out(attn, o_in, cfg, whole=True),
               "gate": whole(gate, ffn.gate), "up": whole(up, ffn.up),
               "down": apply_linear_swiglu(ffn.down, gate, up, mode=mode)}
        kinds = {name: getattr(lin, "shard") for name, lin in (
            ("wq", attn.wq), ("wo", attn.wo), ("down", ffn.down))}
    return {k: t.float().cpu().numpy() for k, t in out.items()}, kinds


def fails(mesh):
    """A rank program that fails on rank 1."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def stalls(mesh):
    """Rank 0 waits in a collective that rank 1 never joins."""
    if mesh.rank == 0:
        mesh.psum(torch.ones(1))
    else:
        import time
        time.sleep(60)
    return mesh.rank


def collectives(mesh):
    """psum, pmax and all_gather of rank-dependent tensors."""
    r = mesh.rank
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    i = torch.tensor([r + 1], dtype=torch.int32)
    return {"psum": mesh.psum(x).numpy(), "psum_int": mesh.psum(i).numpy(),
            "pmax": mesh.pmax(-x).numpy(),
            "gather": mesh.all_gather(x[None], dim=1).numpy(),
            "bounds": mesh.shard_bounds(8)}
