#!/usr/bin/env python3
"""Device time of K1 and of the SwiGLU stretch, for this or another checkout.

    python3 tools/quant_act_times.py [--src DIR] [--prefill]

Times, in bf16, one ``quant_act`` launch as that checkout's wrapper plans
it at K1's served shapes: distilbert_paper's 256 and 4 rows over 768 and
3072, qwen2.5-3b's 4, 20 and 8192 rows over 2048 and 11008, gemma2-27b's 4
and 8192 rows over 36864.  At qwen2.5-3b's 4, 20 and 8192 rows over 11008
it times the stretch ahead of the down projection: ``F.silu(gate) * up``
then ``quant_act`` (every checkout), and ``quant_act_glu`` where the
checkout has it.  With ``--prefill`` also ``prefill_step`` of qwen2.5-3b
(w8a8, bf16, 36 layers, weights from a seeded generator) on one prompt of
8192 tokens: host ms after ``torch.cuda.synchronize()``, the least of 3
runs after a warm-up (the device is busy ~98 % of it).

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, unpacked under ``build/``), so two versions compare on one
card in one command: run parent, change, change, parent.  Kernel times are
``chip_smoke.device_ms``'s: a CUDA graph of many launches over input copies
beyond L2, timed with CUDA events.  Prints one JSON object as its last
line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (its timers; it imports no repro_torch)

K1_SHAPES = [(256, 768), (256, 3072), (4, 768), (4, 3072),
             *[(m, k) for m in (4, 20, 8192) for k in (2048, 11008)],
             (4, 36864), (8192, 36864)]
GLU_ROWS = (4, 20, 8192)
PROMPT = 8192


def launches(m):
    return 10 if m > 1024 else 200


def prefill_ms(dev, runs=3):
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.engine import prefill_step
    cfg = get_config("qwen2_5_3b").replace(quant_proj="w8a8")
    model = quantize_model_params(init_model(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    prefill_step(model, tokens, cfg)
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_step(model, tokens, cfg)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory to import repro_torch from")
    parser.add_argument("--prefill", action="store_true",
                        help="also time qwen2.5-3b's prefill_step")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    if not torch.cuda.is_available():
        print("quant_act_times: no CUDA device visible to torch",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.quant_act import ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"quant_act_times: {ops.__file__} on {smi}", flush=True)
    out = {"src": str(args.src), "device": smi, "quant_act": {},
           "swiglu_unfused": {}, "quant_act_glu": {}}

    def unfused(g, u):
        return ops.quant_act(torch.nn.functional.silu(g) * u)

    with torch.inference_mode():
        for m, k in K1_SHAPES:
            sets = [(chip_smoke.randn((m, k), i, dev, 1.0, torch.bfloat16),)
                    for i in range(chip_smoke.n_copies(2 * m * k))]
            ms = chip_smoke.device_ms(ops.quant_act, sets, launches(m))
            out["quant_act"][f"{m}x{k}"] = ms
            print(f"  quant_act     ({m},{k}): {ms:.5f} ms", flush=True)
            del sets
        for m in GLU_ROWS:
            sets = [tuple(chip_smoke.randn((m, 11008), 2 * i + j, dev, 1.0,
                                           torch.bfloat16) for j in (0, 1))
                    for i in range(chip_smoke.n_copies(4 * m * 11008))]
            ms = chip_smoke.device_ms(unfused, sets, launches(m))
            out["swiglu_unfused"][f"{m}x11008"] = ms
            print(f"  silu * up, K1 ({m},11008): {ms:.5f} ms", flush=True)
            if hasattr(ops, "quant_act_glu"):
                ms = chip_smoke.device_ms(ops.quant_act_glu, sets,
                                          launches(m))
                out["quant_act_glu"][f"{m}x11008"] = ms
                print(f"  quant_act_glu ({m},11008): {ms:.5f} ms", flush=True)
            del sets
        torch.cuda.empty_cache()
        if args.prefill:
            out["prefill_step_ms"] = prefill_ms(dev)
            print(f"  prefill_step qwen2.5-3b 1 x {PROMPT}: "
                  f"{out['prefill_step_ms']:.3f} ms (host, least of 3)",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
