"""Rank programs for the compressed mesh steps
(``tests/test_torch_compress_mesh.py``): each runs in a process that
``launch.mesh.spawn_ranks`` starts (over gloo), on its mesh's device, and
imports neither JAX nor the JAX package (the test process holds those)."""
from __future__ import annotations

import torch

from repro_torch.bridge import params_from_numpy, shard_train_state
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.transformer import init_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.compression import GradCompressor
from repro_torch.training.train_step import make_train_step, trainable

# the noise's seed on every rank and in the test's single-device runs
SEED = 7


def schedule():
    """The learning rate of ``tests/test_torch_training.py``'s runs."""
    return warmup_cosine(1e-3, 2, 10)


def _cpu(named):
    return {n: t.detach().cpu().clone() for n, t in named.items()}


def compressed_case(mesh, cfg, tree, stochastic, steps, batch, seq):
    """``steps`` steps of the sharded train state (ZeRO-1 for a bf16
    ``cfg``, the classic layout for f32) with a ``GradCompressor`` on the
    reduced gradients, as the launcher wires it, on SyntheticLM's global
    batches of ``batch`` x ``seq``.  The model comes from the numpy
    ``tree``, or (None) from seed 0.  Returns the metrics of each step,
    the placements, and for each step the compressor's inputs (gradient
    and residual blocks) and outputs (wire and new residual blocks)."""
    dev = mesh.device
    if tree is None:
        model = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    else:
        model = params_from_numpy(tree, cfg, device=dev)
    zero1 = cfg.dtype == "bfloat16"
    opt = AdamW(learning_rate=schedule())
    state = shard_train_state(model, opt, mesh, zero1=zero1)
    gc = GradCompressor(stochastic=stochastic)
    residual = {"r": gc.init_residual(state.master if zero1
                                      else trainable(state.params))}
    generator = torch.Generator(device=dev).manual_seed(SEED)
    specs = state.placement.grad_specs(zero1)
    records = []

    def compressor(grads):
        wire, new_res = gc.compress_decompress(
            grads, residual["r"], generator, mesh=mesh, specs=specs)
        records.append({"g": _cpu(grads), "r": _cpu(residual["r"]),
                        "wire": _cpu(wire), "res": _cpu(new_res)})
        residual["r"] = new_res
        return wire

    step = make_train_step(cfg, opt, compressor=compressor)
    data = SyntheticLM(cfg.vocab_size, batch, seq, seed=0,
                       frontend=cfg.frontend, frontend_len=cfg.frontend_len,
                       d_model=cfg.d_model, device=dev)
    metrics = []
    for i in range(steps):
        state, m = step(state, data.batch_at(i))
        metrics.append({k: float(v) for k, v in m.items()})
    p = state.placement
    return {"metrics": metrics, "steps": records, "specs": specs,
            "relayout": sorted(p.relayout), "partial": sorted(p.partial)}


def compress_rank(mesh, cases):
    """``compressed_case`` of each of ``cases`` ({key: its arguments after
    the mesh})."""
    return {key: compressed_case(mesh, *args) for key, args in cases.items()}
