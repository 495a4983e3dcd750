"""Persistent-A fused QKV projection — the ``update_A`` mechanism (paper §4.2).

Attention calls this instead of three ``apply_linear`` calls when fusion is
enabled.  Under ``w8a8`` the activation matrix is quantized once
(``quant_act``, K1) and contracted against Wq, Wk and Wv inside one kernel
launch (``fused_qkv``, K3).  In 'none'/'w8' modes one concatenated GEMM makes the same
single pass over x.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantized_linear import (Linear, QuantMode,
                                              quantize_weight)
from repro_torch.kernels.fused_qkv.ops import fused_qkv
from repro_torch.kernels.quant_act.ops import quant_act


def apply_fused_qkv(pq: Linear, pk: Linear, pv: Linear, x: torch.Tensor, *,
                    mode: QuantMode = "w8a8", out_dtype=None):
    """Returns (q, k, v) = x @ (Wq, Wk, Wv) (+ biases), A loaded once."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()

    def unflatten(y, p):
        if p.b is not None:
            y = y + p.b.to(y.dtype)
        return y.reshape(*lead, y.shape[-1]).to(out_dtype)

    if mode == "w8a8":
        xq = quant_act(x2)
        wqs = [p.w_q if p.w_q is not None else quantize_weight(p.w)
               for p in (pq, pk, pv)]
        # f32 outputs: the bias is added afterwards, then the cast
        q, k, v = fused_qkv(xq, *wqs, out_dtype=torch.float32)
        return unflatten(q, pq), unflatten(k, pk), unflatten(v, pv)

    if mode not in ("none", "w8"):
        raise ValueError(f"unknown mode {mode!r}")

    # Unquantized / weight-only: one concatenated GEMM over x (single pass).
    def w_of(p):
        return (p.w_q.dequantize(x.dtype) if p.w_q is not None
                else p.w.to(x.dtype))

    wq, wk, wv = w_of(pq), w_of(pk), w_of(pv)
    y = x2 @ torch.cat([wq, wk, wv], dim=1)
    nq, nk = wq.shape[1], wk.shape[1]
    q, k, v = y[:, :nq], y[:, nq:nq + nk], y[:, nq + nk:]
    return unflatten(q, pq), unflatten(k, pk), unflatten(v, pv)
