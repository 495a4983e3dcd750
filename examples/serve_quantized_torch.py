"""Continuously-batched int8 serving on the PyTorch/CUDA port's paged-KV
engine: the twin of examples/serve_quantized.py, with the same flags and
output.

    PYTHONPATH=src python examples/serve_quantized_torch.py --requests 6 \
        [--slots 3] [--pool-pages 40] [--page-size 8] [--no-share] \
        [--device cuda|cpu]

Offline weight quantization, per-row activation quantization each step
(K1), int8 GEMMs for every projection with the dequant epilogue (K2, K3),
the KV cache in pages of a pool managed by the free-list allocator
(``serving/allocator.py``), attention over the pages (K4).  Requests
arrive mid-stream: the ``Scheduler`` admits them whenever a slot and
enough pool pages are free (prompts sharing a prefix with a live sequence
alias its pages), steps the live batch one decode per tick, and retires
finished sequences so their pages return to the pool.  On the CPU the
kernels' plain PyTorch versions run.

``--mesh N`` (N > 1) raises here: the port serves over a mesh with one
process a rank (``repro_torch.launch.mesh.spawn_ranks``, each rank a
Scheduler on ``CacheConfig(mesh=...)``), which this one-process twin does
not drive yet (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
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
                    help="serve over an N-rank mesh (not in this twin: "
                         "ROADMAP queue 1, item 13)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None, model: Model | None = None, cfg=None) -> Scheduler:
    """Serves the trace; returns the drained Scheduler (``finished`` holds
    each request's tokens).  ``model``: the w8a8 model to serve (default:
    drawn from a seeded generator, then quantized); ``cfg``: its config
    (default: ``--arch``'s smoke config under w8a8)."""
    args = parser().parse_args(argv)
    if args.mesh > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: this twin serves in one process; the "
            "port's mesh serving runs one process a rank "
            "(launch/mesh.py spawn_ranks; ROADMAP queue 1, item 13)")
    dev = resolve_device(args.device)
    cfg = cfg or get_smoke_config(args.arch).replace(quant_proj="w8a8")
    if model is None:
        model = quantize_model_params(init_model(
            torch.Generator().manual_seed(0), cfg.replace(quant_proj="none"),
            device="cpu"))
    sched = Scheduler(model.to(dev), cfg, slots=args.slots,
                      max_len=args.max_len, share_prefix=not args.no_share,
                      bucket=8,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=args.page_size,
                                         pool_pages=args.pool_pages),
                      # pages in the activations' dtype, as K4 reads them
                      # (the projections' K / V are in it already)
                      dtype=cfg.activation_dtype, device=dev)
    trace = make_trace(args, cfg.vocab_size)

    occ0 = sched.pool_occupancy()
    print(f"arch={cfg.name} slots={args.slots} page={args.page_size} "
          f"pool={occ0.total} pages share_prefix={not args.no_share} "
          f"device={dev.type}")
    print(f"{'tick':>4} {'arrive':>6} {'live':>4} {'queue':>5} "
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
            print(f"{tick:>4} {str(arrived or ''):>6} {sched.n_active:>4} "
                  f"{len(sched.queue):>5} {occ.used:>4}/{occ.total:<4} "
                  f"{done or ''}")
            tick += 1
    sec = time.perf_counter() - t0

    n_tokens = sum(len(v) for v in sched.finished.values())
    print(f"\n{len(sched.finished)} requests, {n_tokens} tokens in "
          f"{sec:.2f}s ({n_tokens / sec:.1f} tok/s, host clock), "
          f"peak pool occupancy "
          f"{max(sched.occupancy_log)}/{sched.pool_occupancy().total}")
    for rid in sorted(sched.finished)[:3]:
        print(f"request {rid}: {sched.finished[rid].tolist()}")
    return sched


if __name__ == "__main__":
    main()
