"""Plain PyTorch version of the tiled int8 GEMM (paper Algorithm 1).

The numerics contract of kernel K2: exact int8 x int8 → int32 accumulation,
then ``acc.f32 * (sa * sb)``, then a separate ``+ bias``, then the cast.

The product is taken in float64: every partial sum of int8 products is an
integer below 2^53 (|acc| <= 127^2 * K), so it is exact in any summation
order and on both devices.  CUDA has no int32 ``matmul``, ``torch._int_mm``
refuses M <= 16 (decode), and a float32 product is inexact past 2^24.
"""
from __future__ import annotations

import torch


def int_matmul_exact(a_values: torch.Tensor, b_values: torch.Tensor
                     ) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) → the exact int32 (M, N) product."""
    return (a_values.double() @ b_values.double()).to(torch.int32)


def tiled_matmul_ref(a_values: torch.Tensor, a_scale: torch.Tensor,
                     b_values: torch.Tensor, b_scale: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """C = dequant(int8 A @ int8 B) + bias.

    a_values: (M, K) int8     a_scale: broadcastable to (M, 1) f32
    b_values: (K, N) int8     b_scale: broadcastable to (1, N) f32
    bias:     (N,) or (1, N) f32 or None
    """
    return int8_epilogue_ref(int_matmul_exact(a_values, b_values), a_scale,
                             b_scale, bias, out_dtype)


def int8_epilogue_ref(acc: torch.Tensor, a_scale: torch.Tensor,
                      b_scale: torch.Tensor, bias: torch.Tensor | None = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """K2's epilogue alone on an int32 product acc (M, N):
    ``acc.f32 * (sa * sb)``, then ``+ bias``, then the cast."""
    out = acc.float() * (a_scale.float() * b_scale.float())
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out.to(out_dtype)



def matmul_f32_oracle(a: torch.Tensor, b: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Unquantized fp32 reference — the accuracy yardstick (paper §6.2)."""
    out = a.float() @ b.float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return out
