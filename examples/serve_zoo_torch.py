"""One serving loop, three state families, on the PyTorch/CUDA port: the
twin of examples/serve_zoo.py.

    PYTHONPATH=src python examples/serve_zoo_torch.py [--tokens 8] \
        [--slots 3] [--device cuda|cpu]

The sequence-state registry (``serving/state.py``) makes the
``Scheduler``'s admit → step → retire loop family-agnostic: the same
loop below serves

  * ``qwen2_5_3b`` — attention over a paged-KV pool with refcounted prefix
    sharing (``paged_kv`` handler; the pool column counts pages),
  * ``mamba2_370m`` — pure SSM, a fixed recurrent state per slot, no pages
    (``ssm_slot`` handler; the pool column counts slots),
  * ``granite_moe_3b_a800m`` — MoE over paged KV: each live token routes
    to its top-k experts (``paged_kv`` handler).

Add ``zamba2_7b`` through ``--archs`` for the ``hybrid`` handler: SSM
slots and a shared attention's KV through the same loop.  The Scheduler
gets ``config=None``: the registry picks paged KV for attention and MoE,
dense slots for SSM and hybrid.  The models run unquantized in f32, as the
JAX example's; on the card attention over the pages runs K4.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model, init_model
from repro_torch.serving.scheduler import Scheduler

ZOO = ("qwen2_5_3b", "mamba2_370m", "granite_moe_3b_a800m")


def smoke_cfg(arch: str):
    return get_smoke_config(arch).replace(quant_proj="none", dtype="float32")


def make_trace(requests: int, tokens: int, vocab_size: int) -> list:
    """The JAX example's trace, from the same seed."""
    rng = np.random.default_rng(7)
    trace = []
    for i in range(requests):
        p_len = int(rng.integers(4, 14))
        prompt = rng.integers(0, vocab_size, p_len).astype(np.int32)
        trace.append((i, prompt, max(2, tokens - i % 3)))
    return trace


def serve_one(arch: str, *, slots: int, requests: int, tokens: int,
              max_len: int, device="cuda",
              model: Model | None = None) -> Scheduler:
    """Serves ``arch``'s trace; returns the drained Scheduler.  ``model``
    defaults to one drawn from a seeded generator."""
    dev = resolve_device(device)
    cfg = smoke_cfg(arch)
    if model is None:
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    # config=None: the registry picks paged KV for attention / MoE
    # families and the dense slot layout for ssm / hybrid
    sched = Scheduler(model.to(dev), cfg, slots=slots, max_len=max_len,
                      bucket=8, device=dev)
    trace = make_trace(requests, tokens, cfg.vocab_size)

    occ0 = sched.pool_occupancy()
    unit = "pages" if "page_table" in sched.cache else "slots"
    print(f"\n--- {cfg.name} [{sched.handler.name}] "
          f"pool={occ0.total} {unit} ---")
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
    print(f"{len(sched.finished)} requests, {n_tokens} tokens in "
          f"{sec:.2f}s ({n_tokens / sec:.1f} tok/s, host clock)")
    for rid in sorted(sched.finished)[:2]:
        print(f"request {rid}: {sched.finished[rid].tolist()}")
    return sched


def main(argv=None, models: dict | None = None) -> dict:
    """Serves each arch; returns {arch: the drained Scheduler}.  ``models``
    may give an arch's model."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(ZOO),
                    help="model zoo to serve (e.g. add zamba2_7b for "
                         "the hybrid handler)")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return {arch: serve_one(arch, slots=args.slots, requests=args.requests,
                            tokens=args.tokens, max_len=args.max_len,
                            device=args.device,
                            model=(models or {}).get(arch))
            for arch in args.archs}


if __name__ == "__main__":
    main()
