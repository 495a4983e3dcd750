"""Wrapper for the tiled int8 GEMM: CUDA kernel K2 on the card, the plain
version on the CPU.

The kernel takes fixed 64 x 64 x 64 tiles and handles ragged M, N and K
itself (no host-side padding); plan selection comes with the Hopper
dispatcher (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import ref as _ref

__all__ = ["tiled_matmul", "OUT_DTYPES"]

OUT_DTYPES = (torch.float32, torch.bfloat16)


def check_operand(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: kernel needs a contiguous tensor")


def row_scale(a: QTensor) -> torch.Tensor:
    """A's per-row (or per-tensor) scale as a contiguous (M, 1) f32."""
    m = a.values.shape[0]
    return torch.broadcast_to(a.scale.float(), (m, 1)).contiguous()


def col_scale(b: QTensor) -> torch.Tensor:
    """B's per-column (or per-tensor) scale as a contiguous (1, N) f32."""
    n = b.values.shape[1]
    return torch.broadcast_to(b.scale.float(), (1, n)).contiguous()


def tiled_matmul(a: QTensor, b: QTensor, bias: torch.Tensor | None = None, *,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """C = dequant(A_q @ B_q) + bias for quantized operands.

    ``a``: QTensor (M, K) with per-row (M,1) / per-tensor scale.
    ``b``: QTensor (K, N) with per-col (1,N) / per-tensor scale.
    ``bias``: (N,) f32 or None.
    """
    m, k = a.values.shape
    k2, n = b.values.shape
    if k != k2:
        raise ValueError(f"tiled_matmul: inner dims differ ({k} vs {k2})")
    a_scale, b_scale = row_scale(a), col_scale(b)
    dev = a.values.device
    if dev.type == "cpu":
        return _ref.tiled_matmul_ref(a.values, a_scale, b.values, b_scale,
                                     bias, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {dev}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"tiled_matmul kernel writes f32 or bf16, not {out_dtype}")
    check_operand(a.values, torch.int8, (m, k), "A values")
    check_operand(b.values, torch.int8, (k, n), "B values")
    if bias is not None:
        check_operand(bias, torch.float32, (n,), "bias")
    for t in (b.values, a_scale, b_scale) + ((bias,) if bias is not None else ()):
        if t.device != dev:
            raise ValueError(f"tiled_matmul: operand on {t.device}, A on {dev}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.library("int8_gemm").launch_tiled_matmul
    _build.check(fn(a.values.data_ptr(), a_scale.data_ptr(),
                    b.values.data_ptr(), b_scale.data_ptr(),
                    bias.data_ptr() if bias is not None else None,
                    out.data_ptr(), m, k, n, int(out_dtype == torch.bfloat16),
                    dev.index, torch.cuda.current_stream(dev).cuda_stream),
                 "tiled_matmul")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
