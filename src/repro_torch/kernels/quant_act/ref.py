"""Plain PyTorch versions of fused row-wise activation quantization and
of its SwiGLU mode."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def row_absmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Each row's absmax in f32: (M, K) → (M, 1) (K1's absmax mode)."""
    return torch.amax(x.float().abs(), dim=1, keepdim=True)


def quant_act_ref(x: torch.Tensor, qmax: int = 127,
                  absmax: torch.Tensor | None = None):
    """Per-row symmetric absmax quantization of activations.

    x: (M, K) float → (values int8 (M, K), scale f32 (M, 1)).
    Matches core.quantization.quantize(x, channel_axes=(0,)) exactly.
    Both divisions are tensor by tensor: on CUDA, PyTorch turns a division
    by a Python scalar into a multiply by its reciprocal, which is not the
    IEEE quotient the reference and kernel K1 compute.  ``absmax`` (M, 1)
    f32, where given, takes the place of the rows' own (K1's
    given-absmax mode: a row split over ranks quantizes with the maximum
    of its parts' absmaxes, bitwise the whole row's quantization).
    """
    xf = x.float()
    if absmax is None:
        absmax = row_absmax_ref(xf)
    scale = torch.where(absmax <= 1e-12, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, qmax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def quant_act_glu_ref(gate: torch.Tensor, up: torch.Tensor, qmax: int = 127,
                      absmax: torch.Tensor | None = None):
    """``quant_act_ref`` of the SwiGLU product ``F.silu(gate) * up``, each
    op in the operands' dtype, as the unfused FFN computes it."""
    return quant_act_ref(F.silu(gate) * up, qmax, absmax)


def row_absmax_glu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``row_absmax_ref`` of the SwiGLU product."""
    return row_absmax_ref(F.silu(gate) * up)
