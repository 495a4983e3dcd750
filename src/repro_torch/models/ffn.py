"""Dense feed-forward blocks (GLU family) — quantizable projections."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantized_linear import (Linear, apply_linear,
                                               apply_linear_swiglu,
                                               apply_linears, init_linear)
from repro_torch.models.config import ModelConfig

_ACT = {
    "swiglu": F.silu,
    "geglu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_mlp": lambda x: F.gelu(x, approximate="tanh"),
}


class FFN(nn.Module):
    """``up`` and ``down`` projections, plus ``gate`` for the GLU types."""

    def __init__(self, up: Linear, down: Linear, gate: Linear | None = None):
        super().__init__()
        self.gate = gate
        self.up = up
        self.down = down


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> FFN:
    d_ff = d_ff or cfg.d_ff
    gate = None
    if cfg.ffn_type in ("swiglu", "geglu"):
        gate = init_linear(generator, cfg.d_model, d_ff)
    up = init_linear(generator, cfg.d_model, d_ff)
    down = init_linear(generator, d_ff, cfg.d_model,
                       scale=(d_ff ** -0.5) / max(cfg.n_layers, 1) ** 0.5)
    return FFN(up, down, gate)


def apply_ffn(params: FFN, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _ACT[cfg.ffn_type]
    mode = cfg.quant_proj
    if params.gate is None:
        return apply_linear(params.down, act(apply_linear(params.up, x,
                                                          mode=mode)),
                            mode=mode)
    # under w8a8 one K1 of x serves gate and up, and in SwiGLU the product
    # is quantized in K1's launch (bitwise the composition either way)
    gate, up = apply_linears((params.gate, params.up), x, mode=mode)
    if cfg.ffn_type == "swiglu":
        return apply_linear_swiglu(params.down, gate, up, mode=mode)
    return apply_linear(params.down, act(gate) * up, mode=mode)
