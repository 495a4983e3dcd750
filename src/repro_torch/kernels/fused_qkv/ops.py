"""Wrapper for the fused QKV projection (update_A analogue): CUDA kernel K3
on the card, the plain version on the CPU.

One launch computes Q, K and V from the same int8 activation panel: the
kernel walks the column space [Nq | Nkv | Nkv] as one grid, so K and V cost
only the column tiles they have (GQA: Nkv <= Nq).  The weights are read
K-major; the plan is the dispatcher's for the fused shape
(``core.dispatch.select_fused_plan``), K2's variants over the three
widths.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.fused_qkv import ref as _ref
from repro_torch.kernels.tiled_matmul.ops import (OUT_DTYPES, GemmPlan,
                                                  check_depth, check_operand,
                                                  check_plan, check_weight,
                                                  col_scale, is_aligned,
                                                  plan_args, plan_for,
                                                  row_scale, split_scratch)

__all__ = ["fused_qkv"]


def fused_qkv(a: QTensor, wq: QTensor, wk: QTensor, wv: QTensor, *,
              out_dtype=torch.bfloat16, plan: GemmPlan | None = None):
    """(q, k, v) = dequant(A_q @ [Wq|Wk|Wv]) in one launch.

    a: (M, K) QTensor, per-row scale.  w*: (K, N*) QTensors, per-col scales,
    on the card K-major; Wk and Wv share one width Nkv <= Nq.  ``plan``:
    launch this plan (checked) instead of the dispatcher's, as
    ``tiled_matmul``'s.
    """
    m, k = a.values.shape
    nq, nkv = wq.values.shape[1], wk.values.shape[1]
    if wv.values.shape[1] != nkv:
        raise ValueError("fused_qkv: Wk and Wv must have the same width")
    if nkv > nq:
        raise ValueError(f"fused_qkv: Nkv ({nkv}) > Nq ({nq})")
    check_depth(k, "fused_qkv")
    a_scale = row_scale(a)
    sq, sk, sv = col_scale(wq), col_scale(wk), col_scale(wv)
    dev = a.values.device
    if dev.type == "cpu":
        return _ref.fused_qkv_ref(a.values, a_scale, wq.values, sq,
                                  wk.values, sk, wv.values, sv,
                                  out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_qkv: unsupported device {dev}")
    no_backward("fused_qkv (K3)", a.values, a.scale,
                *(x for w in (wq, wk, wv) for x in (w.values, w.scale)))
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"fused_qkv kernel writes f32 or bf16, not {out_dtype}")
    check_operand(a.values, torch.int8, (m, k), "A values")
    check_weight(wq.values, (k, nq), "Wq values")
    check_weight(wk.values, (k, nkv), "Wk values")
    check_weight(wv.values, (k, nkv), "Wv values")
    for t in (wq.values, wk.values, wv.values, a_scale, sq, sk, sv):
        if t.device != dev:
            raise ValueError(f"fused_qkv: operand on {t.device}, A on {dev}")
    operands = (a.values, wq.values, wk.values, wv.values)
    if plan is None:
        plan = plan_for(m, (nq, nkv, nkv), k, out_dtype, *operands)
    else:
        check_plan(plan, m, (nq, nkv, nkv), k, is_aligned(*operands))
    q = torch.empty((m, nq), dtype=out_dtype, device=dev)
    k_out = torch.empty((m, nkv), dtype=out_dtype, device=dev)
    v = torch.empty((m, nkv), dtype=out_dtype, device=dev)
    ws = split_scratch(plan, m, nq + 2 * nkv, dev)
    fn = _build.library("int8_gemm").launch_fused_qkv
    _build.check(fn(a.values.data_ptr(), a_scale.data_ptr(),
                    wq.values.data_ptr(), sq.data_ptr(),
                    wk.values.data_ptr(), sk.data_ptr(),
                    wv.values.data_ptr(), sv.data_ptr(),
                    q.data_ptr(), k_out.data_ptr(), v.data_ptr(),
                    ws.data_ptr() if ws is not None else None,
                    m, k, nq, nkv, int(out_dtype == torch.bfloat16),
                    *plan_args(plan), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "fused_qkv")
    fused_qkv.launches += 1
    fused_qkv.plans[plan.variant] += 1
    fused_qkv.launched_plans[plan] += 1
    return q, k_out, v


fused_qkv.launches = 0
# launches by variant since the last reset, as tiled_matmul.plans
fused_qkv.plans = collections.Counter()
fused_qkv.launched_plans = collections.Counter()
