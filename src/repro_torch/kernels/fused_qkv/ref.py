"""Plain PyTorch version of the fused (persistent-A) QKV projection."""
from __future__ import annotations

import torch

from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref


def fused_qkv_ref(a_values: torch.Tensor, a_scale: torch.Tensor,
                  wq, sq, wk, sk, wv, sv,
                  bq=None, bk=None, bv=None, out_dtype=torch.bfloat16):
    """Three independent dequantized GEMMs sharing the A operand.

    a_values (M, K) int8; a_scale (M, 1); w* (K, N*) int8; s* (1, N*).
    """
    q = tiled_matmul_ref(a_values, a_scale, wq, sq, bq, out_dtype)
    k = tiled_matmul_ref(a_values, a_scale, wk, sk, bk, out_dtype)
    v = tiled_matmul_ref(a_values, a_scale, wv, sv, bv, out_dtype)
    return q, k, v
