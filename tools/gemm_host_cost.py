#!/usr/bin/env python3
"""Host time of one call of the port's int8 GEMM wrappers (K2, K3).

    python3 tools/gemm_host_cost.py [--src DIR] [--calls N] [--repeats R]
                                    [--passes P]

Times, on the host's clock, how long ``tiled_matmul`` and ``fused_qkv``
(``src/repro_torch/kernels/``) take to return at qwen2.5-3b's decode and
verify shapes (M = 4 and 20: wo, gate / up, down and the fused QKV): the
card is synchronized, then ``--calls`` calls are made back to back and the
loop's time is divided by their number.  At these shapes the card runs a
call faster than the host issues one, so the queue never fills and the
figure is the wrapper's own cost: its checks, its plan, the launcher's
descriptors and the launches.  The least of ``--repeats`` loops is kept:
the host is shared, and what other processes take only adds to a loop.
The shapes are timed in turn ``--passes`` times, and each keeps its least,
so a slow spell of the host does not fall on one shape's every loop.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, unpacked under ``build/``), so two versions compare on one
card in one command: run parent, change, change, parent.  The weights are made
by each version's own ``quantize_linear``, in the layout that version
stores.  Prints one JSON object as its last line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# (name, M, K, output widths): K2 has one width, K3 three
SHAPES = [(f"{name} M={m}", m, k, ns) for m in (4, 20)
          for name, k, ns in (("fused_qkv", 2048, (2048, 256, 256)),
                              ("wo", 2048, (2048,)),
                              ("gate/up", 2048, (11008,)),
                              ("down", 11008, (2048,)))]


def host_us(fn, calls, repeats):
    """µs a call: the least over ``repeats`` loops of ``calls`` calls."""
    for _ in range(10):
        fn()
    loops = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        loops.append((time.perf_counter() - start) / calls * 1e6)
        torch.cuda.synchronize()
    return min(loops)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory to import repro_torch from")
    parser.add_argument("--calls", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=25)
    parser.add_argument("--passes", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    if not torch.cuda.is_available():
        print("gemm_host_cost: no CUDA device visible to torch",
              file=sys.stderr)
        return 1
    from repro_torch.core.quantization import quantize
    from repro_torch.core.quantized_linear import Linear, quantize_linear
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    calls = {}
    with torch.inference_mode():
        for name, m, k, ns in SHAPES:
            a = quantize(torch.randn((m, k), generator=g, device=dev),
                         channel_axes=(0,))
            ws = [quantize_linear(Linear(w=torch.randn(
                (k, n), generator=g, device=dev) * 0.05)).w_q for n in ns]
            if len(ns) == 1:
                def call(a=a, w=ws[0]):
                    tiled_matmul(a, w)
            else:
                def call(a=a, ws=ws):
                    fused_qkv(a, *ws)
            calls[name] = call
        rows = {name: float("inf") for name in calls}
        for _ in range(args.passes):
            for name, call in calls.items():
                rows[name] = min(rows[name],
                                 host_us(call, args.calls, args.repeats))
    for name, us in rows.items():
        print(f"  {name:16s} {us:8.2f} us a call", flush=True)
    print(json.dumps({"src": str(args.src), "device": smi,
                      "host_us": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
