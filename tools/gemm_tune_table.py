#!/usr/bin/env python3
"""Tune the port's int8 GEMMs (K2, K3) on one card and write the table
that ships with the package (``src/repro_torch/core/gemm_tune.json``).

    python3 tools/gemm_tune_table.py --out PATH [--iters N]

For each shape below, ``dispatch.tune`` / ``tune_fused`` measure every
candidate plan (``src/repro_torch/core/dispatch.py``: each first held
bitwise against the plain version on the card, then timed as the median of
``--iters`` replays of a CUDA graph of launches over operand copies beyond
L2) and keep the analytic pick unless another beats it by more than the
replays' spread.  Each candidate's µs is printed beside the analytic
pick's; the winners go to ``--out`` under unqualified keys (a shipped
table's), with their µs, the analytic pick's, the spread and the card's
name and power limit.  The tuning itself writes to a temporary table, never
the user's.  The last line is one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
# (M, K, widths, out dtypes): K2 has one width, K3 three (Nq, Nkv, Nkv)
PAPER = [(64, 768, (n,), (BF16, F32)) for n in (768, 3072)] + [
    (64, 3072, (768,), (BF16, F32)), (64, 768, (768, 768, 768), (BF16, F32))]
# distilbert_paper's served rows (a 4 x 64-token prefill, 4-row decode)
DISTILBERT = [(m, k, ns, (BF16,)) for m in (256, 4)
              for k, ns in ((768, (768, 768, 768)), (768, (768,)),
                            (768, (3072,)), (3072, (768,)))]
# qwen2.5-3b's at decode, verify and an 8192-token prefill
QWEN = [(m, k, ns, (BF16,)) for m in (4, 20, 8192)
        for k, ns in ((2048, (2048, 256, 256)), (2048, (2048,)),
                      (2048, (11008,)), (11008, (2048,)))]
# the two plan misses the records name: zamba2-7b's in_B / in_C (64) and
# in_dt (112) at decode, and N = 64 at 8192 rows
MISSES = [(4, 3584, (64,), (BF16,)), (4, 3584, (112,), (BF16,)),
          (8192, 3584, (64,), (BF16,)), (8192, 3584, (112,), (BF16,))]
SHAPES = PAPER + DISTILBERT + QWEN + MISSES


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_tune_table: no CUDA device visible to torch",
              file=sys.stderr)
        return 1
    from repro_torch.core import dispatch
    from repro_torch.kernels import _build
    _build.build()
    scratch = tempfile.mkdtemp(prefix="gemm_tune_")
    os.environ[dispatch.CACHE_ENV] = os.path.join(scratch, "tune.json")
    os.environ[dispatch.SEED_ENV] = "0"
    dispatch.reset_cache_state()
    print(f"gemm_tune_table on {dispatch.card()} (device µs a call; "
          "* = the analytic pick, > = the winner)")
    table, rows = {}, []
    with torch.inference_mode():
        for m, k, ns, dtypes in SHAPES:
            for dt in dtypes:
                results = []
                if len(ns) == 1:
                    win = dispatch.tune(m, k, ns[0], out_dtype=dt,
                                        iters=args.iters, results=results)
                    key = dispatch._key(m, k, ns[0], dt)
                else:
                    win = dispatch.tune_fused(m, k, ns[0], ns[1],
                                              out_dtype=dt, iters=args.iters,
                                              results=results)
                    key = dispatch._fused_key(m, k, ns[0], ns[1], dt)
                entry = dispatch.load_cache()[f"{key}:{dispatch.BACKEND}"]
                table[key] = entry
                for i, (plan, us) in enumerate(results):
                    mark = ("*" if i == 0 else " ") + (
                        ">" if plan == win else " ")
                    print(f"  {key:24s} {mark} {plan.variant:5s} "
                          f"n{plan.cols:<3d} split {plan.split:2d}: "
                          f"{us:9.3f}", flush=True)
                margin = entry["analytic_us"] - entry["us"]
                print(f"  {key:24s} analytic {entry['analytic_us']:.3f} µs, "
                      f"kept {entry['us']:.3f} µs (margin {margin:.3f}, "
                      f"spread {entry['spread_us']:.3f})", flush=True)
                rows.append({"key": key, "plan": list(win),
                             "us": entry["us"],
                             "analytic_us": entry["analytic_us"],
                             "spread_us": entry["spread_us"],
                             "candidates": [[list(p), us]
                                            for p, us in results]})
                torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"card": dispatch.card(), "iters": args.iters,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
