#!/usr/bin/env python3
"""Time every variant of the port's int8 GEMMs (K2, K3) on one card.

    python3 tools/gemm_plan_sweep.py [--quick]

For each shape (qwen2.5-3b's and distilbert_paper's served projections,
and the rows between decode and prefill), forces each candidate plan of
``tiled_matmul`` / ``fused_qkv`` (``src/repro_torch/kernels/tiled_matmul/
ops.py``: the wide variant, the swap variant with its K splits; forced by
patching ``gemm_plan`` under ``REPRO_TUNE=off``, so the wrappers still
check each plan and no table entry takes its place) and prints its device
time per launch beside the plan ``gemm_plan`` picks (marked ``*``), each
launch checked bitwise against the plain version first.  Times are ``chip_smoke.device_ms``'s: a CUDA graph of many
launches over operand copies beyond L2, timed with CUDA events.  This is
the evidence behind ``gemm_plan``'s thresholds.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from chip_smoke import device_ms, n_copies, quantized_operands  # noqa: E402
from repro_torch.kernels.tiled_matmul import ops as matmul_ops  # noqa: E402

# (M, output widths, K): K2 has one width, K3 three
SHAPES = [
    # distilbert_paper at prefill (M=256) and decode (M=4)
    (256, [768, 768, 768], 768), (256, [768], 768), (256, [3072], 768),
    (256, [768], 3072), (4, [768, 768, 768], 768), (4, [768], 3072),
    # qwen2.5-3b at decode, verify, short prefills and an 8192-token prompt
    *[(m, ns, k) for m in (4, 20, 65, 128, 256, 512, 1024, 8192)
      for ns, k in (([2048, 256, 256], 2048), ([2048], 2048),
                    ([11008], 2048), ([2048], 11008))],
]
QUICK = [(4, [2048], 11008), (256, [768], 3072), (512, [2048], 2048),
         (512, [11008], 2048)]


def candidates(m, ns, k):
    """The wide plan (from 65 rows), the swap plan (to 1024 rows) at each
    of 1, 2, 4, 8 and 16 splits that K allows, and gemm_plan's own."""
    from repro_torch.core.tiling import BK, SWAP_COLS, GemmPlan
    nk = -(-k // BK)
    plans = []
    if m > SWAP_COLS[-1]:
        plans.append(GemmPlan("wide", 256, 1, nk))
    if m <= 1024:
        cols = next((c for c in SWAP_COLS if c >= m), SWAP_COLS[-1])
        for split in (1, 2, 4, 8, 16):
            if split <= nk:
                chunk = -(-nk // split)
                plans.append(GemmPlan("swap", cols, -(-nk // chunk), chunk))
    chosen = matmul_ops.gemm_plan(m, ns, k, aligned=True)
    return list(dict.fromkeys(plans + [chosen])), chosen


def time_plan(plan, m, ns, ops, launches):
    """Device ms per launch of K2 (one width, bf16 out) or K3 (three, f32
    out) with ``gemm_plan`` patched to give ``plan``, after a bitwise check
    against the plain version."""
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
    a, ws = ops[0]
    patch = mock.patch.object(matmul_ops, "gemm_plan", lambda *_: plan)
    if len(ns) == 1:
        def run(a, b):
            with patch:
                return tiled_matmul(a, b)
        ok = torch.equal(run(a, ws[0]), tiled_matmul_ref(
            a.values, a.scale, ws[0].values, ws[0].scale, None,
            torch.bfloat16))
        sets = [(a, w[0]) for a, w in ops]
    else:
        def run(a, *w):
            with patch:
                return fused_qkv(a, *w, out_dtype=torch.float32)
        refs = fused_qkv_ref(a.values, a.scale,
                             *sum(((w.values, w.scale) for w in ws), ()),
                             out_dtype=torch.float32)
        ok = all(torch.equal(x, y) for x, y in zip(run(a, *ws), refs))
        sets = [(a, *w) for a, w in ops]
    if not ok:
        raise SystemExit(f"gemm_plan_sweep: {plan} "
                         f"differs from the plain version at ({m}, {ns})")
    return device_ms(run, sets, launches)


def sweep(m, ns, k, dev):
    out_b = 4 if len(ns) == 3 else 2        # K3 writes f32, K2 bf16
    nbytes = m * k + k * sum(ns) + out_b * m * sum(ns)
    ops = [quantized_operands(m, k, ns, dev, seed=i)
           for i in range(n_copies(nbytes))]
    plans, chosen = candidates(m, ns, k)
    launches = 10 if m > 1024 else 200
    rows = []
    for plan in plans:
        rows.append((plan, time_plan(plan, m, ns, ops, launches)))
        print(f"  {m:5d} {'|'.join(map(str, ns)):>15s} {k:6d}  "
              f"{plan.variant:5s} n{plan.cols:<3d} split {plan.split:2d}: "
              f"{rows[-1][1]:.5f} ms{'  *' if plan == chosen else ''}",
              flush=True)
    best = min(rows, key=lambda r: r[1])
    own = dict(rows)[chosen]
    print(f"  {'':27s} gemm_plan's {own:.5f} ms, best {best[1]:.5f} ms "
          f"({own / best[1]:.2f}x)", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="four shapes instead of all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_plan_sweep: no CUDA device visible to torch",
              file=sys.stderr)
        return 1
    from repro_torch.core import dispatch
    os.environ[dispatch.TUNE_ENV] = "off"
    dispatch.reset_cache_state()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"gemm_plan_sweep on {smi} (device ms per launch; * = gemm_plan's "
          "choice)")
    with torch.inference_mode():
        for m, ns, k in (QUICK if args.quick else SHAPES):
            sweep(m, ns, k, dev)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
