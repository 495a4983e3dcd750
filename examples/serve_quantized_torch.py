"""Continuously-batched int8 serving on the PyTorch/CUDA port's paged-KV
engine: the twin of examples/serve_quantized.py, with the same flags and
output.

    PYTHONPATH=src python examples/serve_quantized_torch.py --requests 6 \
        [--slots 3] [--pool-pages 40] [--page-size 8] [--no-share] \
        [--mesh N] [--device cuda|cpu]

Offline weight quantization, per-row activation quantization each step
(K1), int8 GEMMs for every projection with the dequant epilogue (K2, K3),
the KV cache in pages of a pool managed by the free-list allocator
(``serving/allocator.py``), attention over the pages (K4).  Requests
arrive mid-stream: the ``Scheduler`` admits them whenever a slot and
enough pool pages are free (prompts sharing a prefix with a live sequence
alias its pages), steps the live batch one decode per tick, and retires
finished sequences so their pages return to the pool.  On the CPU the
kernels' plain PyTorch versions run.

``--mesh N`` (N > 1) serves over an N-rank ``("model",)`` mesh, where
the JAX example runs one controller over N devices: the port runs one
process a rank (``repro_torch.launch.mesh.spawn_ranks``), each with its
shard of the model (``bridge.shard_model``) and the same Scheduler loop on
its slab of the pool (``CacheConfig(mesh=...)``); rank 0 prints and
returns the finished tokens.  On the CPU the ranks talk over gloo; on the
card over NCCL when there is a card a rank, else over gloo on one card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import types

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import params_from_numpy, params_to_numpy, shard_model
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.models.transformer import Model, init_model
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.scheduler import Scheduler


def make_trace(args, vocab_size: int) -> list:
    """Mixed-length prompts, one arriving each tick; every third reuses a
    long prefix of the first (its admission forks those pages instead of
    recomputing them).  The JAX example's trace, from the same seed."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, vocab_size, args.prompt_len)
    trace = []
    for i in range(args.requests):
        p_len = max(4, args.prompt_len - 2 * (i % args.slots))
        if i % 3 == 2:
            prompt = np.concatenate(
                [base[: p_len - 2], rng.integers(0, vocab_size, 2)])
        else:
            prompt = rng.integers(0, vocab_size, p_len)
        trace.append((i, prompt.astype(np.int32), max(2, args.tokens - i)))
    return trace


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical page pool (default: slots*max_pages; "
                         "smaller values exercise admission control)")
    ap.add_argument("--no-share", action="store_true",
                    help="disable prefix-sharing admissions")
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="serve over an N-rank model-axis mesh, one "
                         "process a rank")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None, model: Model | None = None, cfg=None):
    """Serves the trace; returns the drained Scheduler (``finished`` holds
    each request's tokens), or under ``--mesh N`` rank 0's ``finished``
    and ``occupancy_log``.  ``model``: the w8a8 model to serve (default:
    drawn from a seeded generator, then quantized); ``cfg``: its config
    (default: ``--arch``'s smoke config under w8a8)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg or get_smoke_config(args.arch).replace(quant_proj="w8a8")
    if model is None:
        model = quantize_model_params(init_model(
            torch.Generator().manual_seed(0), cfg.replace(quant_proj="none"),
            device="cpu"))
    if args.mesh == 1:
        return serve(args, model.to(dev), cfg, dev)
    from repro_torch.launch.mesh import spawn_ranks
    if dev.type == "cpu":
        backend, device = "gloo", "cpu"
    elif torch.cuda.device_count() >= args.mesh:
        backend, device = "nccl", "cuda:{rank}"
    else:                   # NCCL refuses two ranks on one card
        backend, device = "gloo", "cuda:0"
    if __name__ != "__main__":
        # the ranks' program is pickled by name: each spawned rank imports
        # this file from its folder, and the name must lead back here even
        # when the file was loaded from its path without registering it
        folder = os.path.dirname(os.path.abspath(__file__))
        if folder not in sys.path:
            sys.path.insert(0, folder)
        if sys.modules.get(__name__) is None:
            here = types.ModuleType(__name__)
            here.__dict__.update(globals())
            sys.modules[__name__] = here
    return spawn_ranks(serve_rank, args.mesh, backend=backend, device=device,
                       args=(args, params_to_numpy(model, cfg), cfg),
                       timeout=600)[0]


def serve_rank(mesh, args, tree, cfg):
    """One rank of ``--mesh N``: its shard of the model and the same
    Scheduler loop on its slab; rank 0 prints."""
    model = shard_model(params_from_numpy(tree, cfg, device=mesh.device),
                        mesh)
    sched = serve(args, model, cfg, mesh.device, mesh=mesh,
                  quiet=mesh.rank != 0)
    return types.SimpleNamespace(finished=sched.finished,
                                 occupancy_log=sched.occupancy_log)


def serve(args, model: Model, cfg, dev, *, mesh=None,
          quiet: bool = False) -> Scheduler:
    """The example's Scheduler over the trace, one tick at a time (a rank's
    shard and slab of ``mesh``, if given); returns it drained."""
    sched = Scheduler(model, cfg, slots=args.slots,
                      max_len=args.max_len, share_prefix=not args.no_share,
                      bucket=8,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=args.page_size,
                                         pool_pages=args.pool_pages,
                                         mesh=mesh),
                      # pages in the activations' dtype, as K4 reads them
                      # (the projections' K / V are in it already)
                      dtype=cfg.activation_dtype, device=dev)
    trace = make_trace(args, cfg.vocab_size)
    say = (lambda *a, **k: None) if quiet else print

    occ0 = sched.pool_occupancy()
    say(f"arch={cfg.name} slots={args.slots} page={args.page_size} "
        f"pool={occ0.total} pages share_prefix={not args.no_share} "
        f"device={dev.type}")
    say(f"{'tick':>4} {'arrive':>6} {'live':>4} {'queue':>5} "
        f"{'pool':>9} {'finished this tick'}")
    t0 = time.perf_counter()
    tick, pending = 0, sorted(trace, key=lambda r: r[0])
    with torch.inference_mode():
        while pending or sched.queue or sched.n_active:
            arrived = []
            while pending and pending[0][0] <= tick:
                _, prompt, budget = pending.pop(0)
                arrived.append(sched.submit(prompt, budget))
            done = sched.step()
            occ = sched.pool_occupancy()
            say(f"{tick:>4} {str(arrived or ''):>6} {sched.n_active:>4} "
                f"{len(sched.queue):>5} {occ.used:>4}/{occ.total:<4} "
                f"{done or ''}")
            tick += 1
    sec = time.perf_counter() - t0

    n_tokens = sum(len(v) for v in sched.finished.values())
    say(f"\n{len(sched.finished)} requests, {n_tokens} tokens in "
        f"{sec:.2f}s ({n_tokens / sec:.1f} tok/s, host clock), "
        f"peak pool occupancy "
        f"{max(sched.occupancy_log)}/{sched.pool_occupancy().total}")
    for rid in sorted(sched.finished)[:3]:
        say(f"request {rid}: {sched.finished[rid].tolist()}")
    return sched


if __name__ == "__main__":
    main()
