"""Wrapper for fused activation quantization: CUDA kernel K1 on the card,
the plain version on the CPU."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.quant_act import ref as _ref

__all__ = ["quant_act"]

_LAUNCHERS = {torch.float32: "launch_quant_act_f32",
              torch.bfloat16: "launch_quant_act_bf16"}


def quant_act(x: torch.Tensor) -> QTensor:
    """Per-row int8 quantization of a 2-D activation matrix (M, K)."""
    if x.dim() != 2:
        raise ValueError(f"quant_act takes a 2-D (M, K) matrix, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        values, scale = _ref.quant_act_ref(x)
        return QTensor(values=values, scale=scale, bits=8)
    if x.device.type != "cuda":
        raise ValueError(f"quant_act: unsupported device {x.device}")
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"quant_act kernel takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quant_act kernel needs a contiguous input")
    m, k = x.shape
    values = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library("quant_act"), _LAUNCHERS[x.dtype])
    _build.check(fn(x.data_ptr(), values.data_ptr(), scale.data_ptr(), m, k,
                    127, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "quant_act")
    quant_act.launches += 1
    return QTensor(values=values, scale=scale, bits=8)


quant_act.launches = 0
