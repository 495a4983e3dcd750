"""Rank programs for the SSM and hybrid mesh tests
(``tests/test_torch_ssm_mesh.py``): each runs in a process that
``launch.mesh.spawn_ranks`` starts (over gloo), on its mesh's device, and
imports neither JAX nor the JAX package (the test process holds those)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.bridge import (params_from_numpy, shard_model,
                                shard_train_state)
from repro_torch.models import ssm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = ("cacheless", "decode", "commit")
# prefill-commit's rows: each row's committed tokens (one row commits none)
COMMIT_VALID = (13, 5, 0)


@contextlib.contextmanager
def recorded_stages(into: list):
    """Within the block, each ``apply_mamba2`` call appends a dict to
    ``into``: its ``in_z`` / ``in_x`` outputs (``z``, ``x``: a rank's
    columns) and the gated norm's input ``y`` (the pre-norm scan output
    plus the skip term, a rank's channels)."""
    linears, norm = ssm.apply_linears, ssm._gated_norm

    def rec_linears(projections, x, **kw):
        out = linears(projections, x, **kw)
        if len(projections) == len(ssm.IN_PROJ):
            into.append({"z": out[0], "x": out[1]})
        return out

    def rec_norm(y, z, *args, **kw):
        into[-1]["y"] = y
        return norm(y, z, *args, **kw)

    ssm.apply_linears, ssm._gated_norm = rec_linears, rec_norm
    try:
        yield
    finally:
        ssm.apply_linears, ssm._gated_norm = linears, norm


def _cpu(t):
    return t.detach().float().cpu().clone()


def block_inputs(cfg, b, seed, dtype):
    """Seeded inputs of layer 0's Mamba2 block in each mode: x, the whole
    carried state (decode, commit) and ``n_valid`` (commit)."""
    rng = np.random.default_rng(seed)
    k, di, n = cfg.ssm_conv - 1, cfg.d_inner, cfg.ssm_state
    h, p = cfg.ssm_n_heads, cfg.ssm_head_dim

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32))

    state = {"h": normal(b, h, p, n, scale=0.1),
             "conv_x": normal(b, k, di), "conv_B": normal(b, k, n),
             "conv_C": normal(b, k, n)}
    return {"cacheless": (normal(b, 32, cfg.d_model).to(dtype), None, None),
            "decode": (normal(b, 1, cfg.d_model).to(dtype), state, None),
            "commit": (normal(b, 20, cfg.d_model).to(dtype), state,
                       torch.tensor(COMMIT_VALID[:b]))}


def _state_slice(state, cfg, lo, hi):
    """A rank's part of a whole Mamba2 state: its heads of ``h``, their
    channels of ``conv_x``, ``conv_B`` / ``conv_C`` whole."""
    p = cfg.ssm_head_dim
    return {"h": state["h"][:, lo:hi],
            "conv_x": state["conv_x"][..., lo * p:hi * p],
            "conv_B": state["conv_B"], "conv_C": state["conv_C"]}


def mamba_block_rank(mesh, cases):
    """Layer 0's Mamba2 block of each case in the three modes, unsharded
    on this rank first (so both runs share its threads), then sharded by
    ``shard_model``.  ``cases`` maps a key to (numpy tree, cfg, dtype name,
    batch, seed).  Returns, by (key, mode): the rank's recorded stages and
    new state, the unsharded run's slice of them, both outputs, and the
    rank's heads."""
    out = {}
    for key, (tree, cfg, dtype, b, seed) in cases.items():
        dt = DTYPES[dtype]
        cfg = cfg.replace(dtype=dtype)
        model = params_from_numpy(tree, cfg, device=mesh.device)
        block = model.layers[0].mamba
        inputs = block_inputs(cfg, b, seed, dt)
        runs = {}
        for tag in ("ref", "got"):
            if tag == "got":
                shard_model(model, mesh)
            lo, hi = ssm.rank_heads(cfg, block.mesh) if tag == "got" \
                else (0, cfg.ssm_n_heads)
            for mode in MODES:
                x, state, nv = inputs[mode]
                if state is not None:
                    state = _state_slice(state, cfg, lo, hi)
                seen = []
                with recorded_stages(seen), torch.inference_mode():
                    y, new = ssm.apply_mamba2(block, x, cfg, state=state,
                                              n_valid=nv)
                runs[(tag, mode)] = (y, seen[0], new)
        lo, hi = ssm.rank_heads(cfg, mesh)
        c0, c1 = lo * cfg.ssm_head_dim, hi * cfg.ssm_head_dim
        for mode in MODES:
            y_ref, st_ref, new_ref = runs[("ref", mode)]
            y_got, st_got, new_got = runs[("got", mode)]
            rec = {"heads": (lo, hi), "got_out": _cpu(y_got),
                   "ref_out": _cpu(y_ref)}
            for name in ("z", "x", "y"):
                rec[f"got_{name}"] = _cpu(st_got[name])
                rec[f"ref_{name}"] = _cpu(st_ref[name][..., c0:c1])
            if new_ref is not None:
                want = _state_slice(new_ref, cfg, lo, hi)
                for name in want:
                    rec[f"got_state_{name}"] = _cpu(new_got[name])
                    rec[f"ref_state_{name}"] = _cpu(want[name])
            out[(key, mode)] = rec
    return out


def _padded(prompts):
    lens = torch.tensor([len(p) for p in prompts])
    padded = torch.zeros((len(prompts), int(lens.max())), dtype=torch.long)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.as_tensor(np.asarray(p))
    return padded, lens


def ssm_mesh_rank(mesh, blocks, serves):
    """One spawn's programs: ``mamba_block_rank`` of ``blocks``, then
    ``ssm_serve_rank`` of each of ``serves`` ({key: its arguments after
    the mesh})."""
    return {"blocks": mamba_block_rank(mesh, blocks),
            "serve": {key: ssm_serve_rank(mesh, *args)
                      for key, args in serves.items()}}


def ssm_serve_rank(mesh, tree, cfg, prompts, steps, sched):
    """The prompts through ``prefill`` and ``steps`` steps of
    ``greedy_decode`` on a dense slot cache of the mesh (f32 state), and,
    with ``sched`` = (requests, budgets, kwargs), through a Scheduler of
    the mesh: first logits, tokens, the slab shapes and the Scheduler's
    tokens in submission order."""
    from repro_torch.serving.cache import CacheConfig, init_cache
    from repro_torch.serving.engine import greedy_decode, prefill
    from repro_torch.serving.scheduler import Scheduler
    dev = mesh.device
    model = shard_model(params_from_numpy(tree, cfg, device=dev), mesh)
    padded, lens = _padded(prompts)
    out = {}
    with torch.inference_mode():
        cache = init_cache(cfg, len(prompts), int(lens.max()) + steps + 4,
                           torch.float32, CacheConfig(mesh=mesh),
                           device=dev)
        out["kv_shard"] = cache.get("kv_shard")
        out["shapes"] = {k: tuple(v.shape) for k, v in cache.items()
                         if torch.is_tensor(v)}
        logits, cache = prefill(model, cache, padded.to(dev), lens.to(dev),
                                cfg)
        toks, cache = greedy_decode(model, cache, logits.argmax(-1)[:, None],
                                    None, steps, cfg)
        out.update(logits=logits.cpu(), tokens=toks.cpu(),
                   seq_lens=cache["seq_lens"].cpu())
        if sched is not None:
            requests, budgets, kw = sched
            s = Scheduler(model, cfg, config=CacheConfig(mesh=mesh),
                          device=dev, **kw)
            rids = [s.submit(np.asarray(p), m)
                    for p, m in zip(requests, budgets)]
            done = s.run(max_ticks=200)
            out["sched"] = [done[r] for r in rids]
    return out


def _slices(named):
    return {n: t.detach().float().cpu().clone() for n, t in named.items()}


def _recording(opt, into):
    """``opt`` with its ``update`` recording the gradients it takes."""
    update = opt.update

    def recorded(grads, st, params, **kw):
        into.update(_slices(grads))
        return update(grads, st, params, **kw)

    object.__setattr__(opt, "update", recorded)
    return opt


def ssm_train_rank(mesh, cases, lr):
    """``train_case_rank`` of each of ``cases`` ({key: (numpy tree, cfg,
    global batch)})."""
    return {key: train_case_rank(mesh, *args, lr)
            for key, args in cases.items()}


def train_case_rank(mesh, tree, cfg, batch, lr):
    """One f32 step (the classic layout) and one bf16 ZeRO-1 step (AdamW
    without clipping) of the sharded train state of ``tree`` on the global
    ``batch``: for each, the metrics and the reduced gradient slices AdamW
    took; for f32 the updated compute slices; for bf16 the initial and
    updated master slices; the placements and the ``partial`` set."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.training.train_step import make_train_step, trainable
    dev = mesh.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    grads = {}
    opt = _recording(AdamW(learning_rate=lr), grads)
    state = shard_train_state(params_from_numpy(tree, cfg, device=dev), opt,
                              mesh, zero1=False)
    state, m = make_train_step(cfg, opt)(state, batch)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
           "params": _slices(trainable(state.params))}
    bcfg = cfg.replace(dtype="bfloat16")
    seen = {}
    bopt = _recording(AdamW(learning_rate=lr, clip_norm=None), seen)
    st = shard_train_state(params_from_numpy(tree, bcfg, device=dev), bopt,
                           mesh, zero1=True)
    p = st.placement
    master0 = _slices(st.master)
    st, bm = make_train_step(bcfg, bopt)(st, batch)
    out["bf16"] = {"metrics": {k: float(v) for k, v in bm.items()},
                   "grads": seen, "master0": master0,
                   "master": _slices(st.master)}
    out.update(compute=p.compute, fsdp=p.fsdp, partial=sorted(p.partial))
    return out
