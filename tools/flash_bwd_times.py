#!/usr/bin/env python3
"""Device time of K5's bf16 backward, for this or another checkout.

    python3 tools/flash_bwd_times.py [--src DIR]

Times ``flash_attention_backward`` (the backward kernels alone, on a
forward's saved f32 output and log-sum-exps) in bf16 at qwen2.5-3b's
training layer (1, 4096, 16/2, 128, causal) and at gemma2-27b's local
layer with S and window cut 4x (1, 2048, 32/16, 128, window 1024, softcap
50): the whole call as ``chip_smoke.device_ms`` times it (a CUDA graph of
4 calls, whose inputs exceed L2, timed with CUDA events), and each of its
kernels' device time a call under ``torch.profiler``.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, unpacked under ``build/``), so two versions compare on one
card in one command: run parent, change, change, parent.  Prints one JSON
object as its last line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (its timers; it imports no repro_torch)

# name, b, s (= t), h, kh, d, options
SHAPES = [("qwen2.5-3b training", 1, 4096, 16, 2, 128, {}),
          ("gemma2-27b local / 4", 1, 2048, 32, 16, 128,
           dict(scale=144 ** -0.5, window=1024, softcap=50.0))]
CALLS = 4


def kernel_ms(fn, calls=CALLS):
    """Device ms a call of each backward kernel over ``calls`` calls of
    ``fn`` under ``torch.profiler`` (``chip_smoke.bwd_split``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return chip_smoke.bwd_split([(e.key, e.count, e.device_time_total / 1e3)
                                 for e in prof.key_averages()
                                 if e.device_time_total > 0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory to import repro_torch from")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward, flash_attention_backward)
    smi = chip_smoke.device_info()
    dev = torch.device("cuda", 0)
    rows = []
    for name, b, s, h, kh, d, opts in SHAPES:
        q, k, v = chip_smoke.flash_inputs(b, s, s, h, kh, d, dev,
                                          torch.bfloat16, seed=70)
        dout = chip_smoke.flash_inputs(b, s, s, h, h, d, dev,
                                       torch.bfloat16, seed=71)[0]
        scale = opts.get("scale", d ** -0.5)
        kw = dict(window=opts.get("window"), softcap=opts.get("softcap"))
        _, lse, out32 = _flash_forward(q, k, v, scale, True, kw["window"],
                                       kw["softcap"], with_lse=True)

        def call():
            return flash_attention_backward(q, k, v, out32, lse, dout,
                                            scale=scale, **kw)
        row = {"shape": name, "ms": chip_smoke.device_ms(call, [()], CALLS),
               "kernels_ms": kernel_ms(call)}
        print(f"  {name} ({b}x{s}x{h}/{kh}x{d}): {row['ms']:.5f} ms; "
              + ", ".join(f"{n} {ms:.5f}"
                          for n, ms in row["kernels_ms"].items()))
        rows.append(row)
        del q, k, v, dout, lse, out32
    print(json.dumps({"src": str(args.src), "device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
