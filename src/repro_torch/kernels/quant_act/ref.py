"""Plain PyTorch versions of fused row-wise activation quantization and
of its SwiGLU mode."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quant_act_ref(x: torch.Tensor, qmax: int = 127):
    """Per-row symmetric absmax quantization of activations.

    x: (M, K) float → (values int8 (M, K), scale f32 (M, 1)).
    Matches core.quantization.quantize(x, channel_axes=(0,)) exactly.
    Both divisions are tensor by tensor: on CUDA, PyTorch turns a division
    by a Python scalar into a multiply by its reciprocal, which is not the
    IEEE quotient the reference and kernel K1 compute.
    """
    xf = x.float()
    absmax = torch.amax(xf.abs(), dim=1, keepdim=True)
    scale = torch.where(absmax <= 1e-12, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quant_act_glu_ref(gate: torch.Tensor, up: torch.Tensor, qmax: int = 127):
    """``quant_act_ref`` of the SwiGLU product ``F.silu(gate) * up``, each
    op in the operands' dtype, as the unfused FFN computes it."""
    return quant_act_ref(F.silu(gate) * up, qmax)
