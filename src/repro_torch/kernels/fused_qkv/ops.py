"""Wrapper for the fused QKV projection (update_A analogue): CUDA kernel K3
on the card, the plain version on the CPU.

One launch computes Q, K and V from the same int8 activation panel, staged
once per K slab for all three weights; K and V cover only the column tiles
they have (GQA: Nkv <= Nq).  Fixed 64 x 64 x 64 tiles, ragged edges in the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.fused_qkv import ref as _ref
from repro_torch.kernels.tiled_matmul.ops import (OUT_DTYPES, check_operand,
                                                  col_scale, row_scale)

__all__ = ["fused_qkv"]


def fused_qkv(a: QTensor, wq: QTensor, wk: QTensor, wv: QTensor, *,
              out_dtype=torch.bfloat16):
    """(q, k, v) = dequant(A_q @ [Wq|Wk|Wv]) with A loaded once.

    a: (M, K) QTensor, per-row scale.  w*: (K, N*) QTensors, per-col scales;
    Wk and Wv share one width Nkv <= Nq.
    """
    m, k = a.values.shape
    nq, nkv = wq.values.shape[1], wk.values.shape[1]
    if wv.values.shape[1] != nkv:
        raise ValueError("fused_qkv: Wk and Wv must have the same width")
    if nkv > nq:
        raise ValueError(f"fused_qkv: Nkv ({nkv}) > Nq ({nq})")
    a_scale = row_scale(a)
    sq, sk, sv = col_scale(wq), col_scale(wk), col_scale(wv)
    dev = a.values.device
    if dev.type == "cpu":
        return _ref.fused_qkv_ref(a.values, a_scale, wq.values, sq,
                                  wk.values, sk, wv.values, sv,
                                  out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_qkv: unsupported device {dev}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"fused_qkv kernel writes f32 or bf16, not {out_dtype}")
    check_operand(a.values, torch.int8, (m, k), "A values")
    check_operand(wq.values, torch.int8, (k, nq), "Wq values")
    check_operand(wk.values, torch.int8, (k, nkv), "Wk values")
    check_operand(wv.values, torch.int8, (k, nkv), "Wv values")
    for t in (wq.values, wk.values, wv.values, a_scale, sq, sk, sv):
        if t.device != dev:
            raise ValueError(f"fused_qkv: operand on {t.device}, A on {dev}")
    q = torch.empty((m, nq), dtype=out_dtype, device=dev)
    k_out = torch.empty((m, nkv), dtype=out_dtype, device=dev)
    v = torch.empty((m, nkv), dtype=out_dtype, device=dev)
    fn = _build.library("int8_gemm").launch_fused_qkv
    _build.check(fn(a.values.data_ptr(), a_scale.data_ptr(),
                    wq.values.data_ptr(), sq.data_ptr(),
                    wk.values.data_ptr(), sk.data_ptr(),
                    wv.values.data_ptr(), sv.data_ptr(),
                    q.data_ptr(), k_out.data_ptr(), v.data_ptr(),
                    m, k, nq, nkv, int(out_dtype == torch.bfloat16),
                    dev.index, torch.cuda.current_stream(dev).cuda_stream),
                 "fused_qkv")
    fused_qkv.launches += 1
    return q, k_out, v


fused_qkv.launches = 0
