"""Rank programs for the MoE mesh tests (``tests/test_torch_moe_mesh.py``):
each runs in a process that ``launch.mesh.spawn_ranks`` starts (over
gloo), on its mesh's device, and imports neither JAX nor the JAX package
(the test process holds those)."""
from __future__ import annotations

import torch

from repro_torch.bridge import (params_from_numpy, shard_model,
                                shard_train_state)
from repro_torch.core.quantization import QTensor
from repro_torch.models.moe import apply_moe, expert_split

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rows(t, mesh):
    """This data rank's equal share of the rows of ``t``."""
    lo, hi = mesh.shard_bounds(t.shape[0], "data")
    return t[lo:hi]


def moe_block_rank(mesh, cases):
    """Layer 0's MoE block of each case on this rank: ``cases`` maps a key
    to (numpy tree, cfg, x (B, S, D) f32 numpy, dtype name, grad).  The
    block runs unsharded on the whole batch first (on this rank, so that
    both runs share its threads), then sharded by ``shard_model`` on the
    data rank's rows.  With ``grad`` the load-balance loss is
    differentiated with respect to the router's weights, both ways, and
    the rank's gradient averaged over ``data`` (as the train step does).
    Returns, by key: the sharded output and load-balance loss, the
    unsharded ones (the rank's rows of the output), the split, the stacks'
    shapes and, with ``grad``, both router gradients."""
    out = {}
    for key, (tree, cfg, x, dtype, grad) in cases.items():
        dt = DTYPES[dtype]
        model = params_from_numpy(tree, cfg, device=mesh.device)
        block = model.layers[0].moe
        x = torch.as_tensor(x, device=mesh.device).to(dt)
        rec = {}
        for tag in ("ref", "got"):
            if tag == "got":
                shard_model(model, mesh)
                x = _rows(x, mesh)
            w = block.router.w.detach().requires_grad_(grad)
            block.router.w = w
            with torch.set_grad_enabled(grad):
                y, aux = apply_moe(block, x, cfg)
                lb = aux["load_balance_loss"]
                if grad:
                    (g,) = torch.autograd.grad(lb, [w])
                    if tag == "got" and mesh.data > 1:
                        g = mesh.psum(g, "data") / mesh.data
                    rec[f"{tag}_router_grad"] = g.detach().cpu()
            rec[f"{tag}_y"] = (y if tag == "got" else _rows(y, mesh)
                               ).detach().float().cpu()
            rec[f"{tag}_lb"] = float(lb)
        rec["split"] = (expert_split(block.experts, cfg)
                        if mesh.size > 1 else None)
        rec["stacks"] = {name: block.experts.stack_shape(name)
                         for name in ("gate", "up", "down")}
        rec["scales"] = {name: tuple(w.scale.shape) for name in
                         ("gate", "up", "down")
                         if isinstance(w := block.experts.weight(name),
                                       QTensor)}
        out[key] = rec
    return out


def _slices(named):
    return {n: t.detach().float().cpu().clone() for n, t in named.items()}


def moe_train_rank(mesh, tree, cfg, batch, lr):
    """One f32 step (the classic layout) and one bf16 ZeRO-1 step (AdamW
    without clipping) of the sharded train state of ``tree`` on the global
    ``batch``: metrics, the updated f32 compute slices; for bf16 the
    reduced gradient slices fed to AdamW, the master, moments and compute
    slices after the step, the initial master slices, the placements and
    the state's bytes on this rank."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.training.train_step import make_train_step, trainable
    dev = mesh.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    opt = AdamW(learning_rate=lr)
    state = shard_train_state(params_from_numpy(tree, cfg, device=dev), opt,
                              mesh, zero1=False)
    state, m = make_train_step(cfg, opt)(state, batch)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "params": _slices(trainable(state.params))}
    bcfg = cfg.replace(dtype="bfloat16")
    bopt = AdamW(learning_rate=lr, clip_norm=None)
    seen = {}
    update = bopt.update

    def recorded(grads, st, params, **kw):
        seen.update(_slices(grads))
        return update(grads, st, params, **kw)

    object.__setattr__(bopt, "update", recorded)
    st = shard_train_state(params_from_numpy(tree, bcfg, device=dev), bopt,
                           mesh, zero1=True)
    p = st.placement
    master0 = _slices(st.master)
    compute = trainable(st.params)
    state_bytes = sum(t.numel() * t.element_size() for t in compute.values())
    state_bytes += sum(
        sum(t.numel() * t.element_size() for t in tree_.values())
        for tree_ in (st.master, st.opt_state.mu, st.opt_state.nu))
    # the compute copy's tensors that are the master's own count once
    state_bytes -= sum(t.numel() * t.element_size()
                       for n, t in compute.items() if t is st.master[n])
    st, bm = make_train_step(bcfg, bopt)(st, batch)
    out["bf16"] = {"metrics": {k: float(v) for k, v in bm.items()},
                   "grads": seen, "master0": master0,
                   "master": _slices(st.master),
                   "compute": _slices(trainable(st.params)),
                   "compute_dtypes": {n: str(t.dtype) for n, t in
                                      trainable(st.params).items()}}
    out.update(compute=p.compute, fsdp=p.fsdp, relayout=sorted(p.relayout),
               state_bytes=state_bytes)
    return out


def moe_sched_rank(mesh, tree, cfg, prompts, budgets, cache_kw, sched_kw,
                   steps):
    """The requests (prompts, budgets) through a Scheduler on this rank's
    shard, all submitted at once, then the prompts through ``prefill`` and
    ``steps`` steps of ``greedy_decode`` on a paged cache of the mesh: the
    Scheduler's tokens in submission order, the greedy tokens, and each
    MoE layer's split on this rank."""
    import numpy as np

    from repro_torch.serving.cache import CacheConfig, init_cache
    from repro_torch.serving.engine import greedy_decode, prefill
    from repro_torch.serving.scheduler import Scheduler
    dev = mesh.device
    model = shard_model(params_from_numpy(tree, cfg, device=dev), mesh)
    sched = Scheduler(model, cfg, config=CacheConfig(mesh=mesh, **cache_kw),
                      device=dev, **sched_kw)
    rids = [sched.submit(np.asarray(p), b) for p, b in zip(prompts, budgets)]
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    padded = torch.zeros((len(prompts), int(lens.max())), dtype=torch.long,
                         device=dev)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.as_tensor(np.asarray(p))
    with torch.inference_mode():
        out = sched.run(max_ticks=200)
        cache = init_cache(cfg, len(prompts), int(lens.max()) + steps + 4,
                           torch.float32,
                           CacheConfig(layout="paged", page_size=4,
                                       mesh=mesh), device=dev)
        logits, cache = prefill(model, cache, padded, lens, cfg)
        greedy, _ = greedy_decode(model, cache,
                                  logits.argmax(-1)[:, None], None, steps,
                                  cfg)
    return {"tokens": [out[r] for r in rids], "greedy": greedy.cpu(),
            "kv_shard": sched.cache.get("kv_shard"),
            "splits": [expert_split(layer.moe.experts, cfg)
                       for layer in model.layers]}
