#!/usr/bin/env python3
"""Host times of the SSM and hybrid serving paths, for this or another
checkout.

    python3 tools/ssm_times.py [--src DIR]

Times, w8a8 bf16 at full width (weights from a seeded generator, each
block quantized as drawn): zamba2-7b's ``prefill_step`` of one prompt of
8192 tokens at all 81 layers (the chunked SSD scan's heaviest served
shape); then, for zamba2-7b at all 81 layers and mamba2-370m at all 48,
``prefill`` of 4 prompts of 64-256 tokens into the dense slot cache and a
decode step (``serve_step``) of those 4 rows; and ``ssd_chunked`` alone
at both models' widths, on 4 rows of 256 tokens and 1 of 8192, from a
seeded state (the mean of 20 calls after a warm-up).  Each time is host
ms after ``torch.cuda.synchronize()``: the first call of a model apart
(it pays first-use costs), then the least of 3 calls (prefill) or the
mean of 16 steps (decode).

``--src`` imports ``repro_torch`` from another checkout's ``src`` (the
parent commit, unpacked under ``build/``), so two versions compare on one
card in one command: run parent, change, change, parent.  Prints one JSON
object as its last line.  Needs a CUDA card.
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
LONG_PROMPT = 8192
PROMPTS = (64, 128, 192, 256)
DECODE_STEPS = 16


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def model_of(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).replace(quant_proj="w8a8", dtype="bfloat16")
    model = init_model(torch.Generator(device=dev).manual_seed(3), cfg,
                       device=dev,
                       each_block=lambda b: quantize_model_params(
                           b, in_place=True))
    return model, cfg


def long_prefill(model, cfg, dev) -> dict:
    from repro_torch.serving.engine import prefill_step
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=torch.Generator().manual_seed(2)
                           ).to(dev)
    first = _ms(lambda: prefill_step(model, tokens, cfg))
    best = min(_ms(lambda: prefill_step(model, tokens, cfg))
               for _ in range(3))
    return {"first_ms": first, "ms": best}


def serve(model, cfg, dev) -> dict:
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import prefill, serve_step
    g = torch.Generator().manual_seed(31)
    lens = torch.tensor(PROMPTS)
    prompts = torch.randint(0, cfg.vocab_size, (len(PROMPTS), max(PROMPTS)),
                            generator=g).to(dev)
    lens = lens.to(dev)
    max_len = max(PROMPTS) + DECODE_STEPS + 1

    def fresh():
        return init_cache(cfg, len(PROMPTS), max_len, torch.bfloat16,
                          device=dev)

    first = _ms(lambda: prefill(model, fresh(), prompts, lens, cfg))
    best = min(_ms(lambda: prefill(model, fresh(), prompts, lens, cfg))
               for _ in range(3))
    cache = fresh()
    logits, cache = prefill(model, cache, prompts, lens, cfg)
    tok = logits.argmax(-1)[:, None]

    def steps():
        nonlocal tok
        for _ in range(DECODE_STEPS):
            lg, _ = serve_step(model, cache, tok, None, cfg)
            tok = lg[:, -1].argmax(-1)[:, None]

    return {"prefill_first_ms": first, "prefill_ms": best,
            "decode_step_ms": _ms(steps) / DECODE_STEPS}


def scan_ms(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssd_chunked
    out = {}
    g = torch.Generator(device=dev).manual_seed(4)
    for arch in ("zamba2_7b", "mamba2_370m"):
        cfg = get_config(arch)
        h, p, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
        for b, length in ((4, 256), (1, 8192)):
            x = (torch.randn(b, length, h, p, generator=g, device=dev)
                 * 0.1).bfloat16()
            a_dt = -torch.rand(b, length, h, generator=g, device=dev) * 0.1
            bm, cm = (torch.randn(b, length, n, generator=g,
                                  device=dev).bfloat16() for _ in range(2))
            h0 = torch.randn(b, h, p, n, generator=g, device=dev) * 0.1

            def run():
                ssd_chunked(x, a_dt, bm, cm, cfg.ssm_chunk, h0)

            run()
            out[f"{arch} {b}x{length}"] = _ms(
                lambda: [run() for _ in range(20)]) / 20
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src directory to import repro_torch from")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    if not torch.cuda.is_available():
        print("ssm_times: no CUDA device visible to torch", file=sys.stderr)
        return 1
    import repro_torch
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"ssm_times: {repro_torch.__file__} on {smi}", flush=True)
    out = {"src": str(args.src), "device": smi}
    with torch.inference_mode():
        out["ssd_chunked"] = scan_ms(dev)
        print(f"  ssd_chunked: {json.dumps(out['ssd_chunked'])}", flush=True)
        for arch in ("zamba2_7b", "mamba2_370m"):
            model, cfg = model_of(arch, dev)
            if arch == "zamba2_7b":
                out["zamba2_7b prefill_step"] = long_prefill(model, cfg, dev)
            out[f"{arch} serve"] = serve(model, cfg, dev)
            mine = {k: v for k, v in out.items() if k.startswith(arch)}
            print(f"  {arch}: {json.dumps(mine)}", flush=True)
            del model
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
