"""QuantizedLinear — the FPGAQuantizedLinear analogue (paper §6.2).

A projection primitive with three modes, selected per model from the
config's ``quant_proj``:

  * ``none``  — bf16/f32 GEMM (the baseline the paper compares against)
  * ``w8``    — weight-only int8 (weights dequantized on the fly)
  * ``w8a8``  — the paper's technique: per-row int8 activations
                (``quant_act``, kernel K1) times per-channel int8 weights
                with an int32 accumulator and a dequant + bias epilogue
                (``tiled_matmul``, kernel K2).

A ``Linear`` module holds either master float weights ``w`` (K, N) or their
offline quantization ``w_q`` (int8 values + (1, N) f32 scales), and an
optional f32 bias ``b``; ``quantize_linear`` converts one into the other.
Quantized values rest K-major (``quantize_weight``): one (N, K)-contiguous
copy, seen as (K, N), the layout kernel K2 reads.

Over a serving mesh (``bridge.shard_model``) a ``Linear`` holds one rank's
slice and its ``shard`` says which:

  * ``"column"`` — the rank's output columns (Q/K/V on the rank's heads,
    the FFN's gate and up, the head's vocab slice).  Each column is
    computed whole on one rank, so the outputs are bitwise the unsharded
    ones; nothing here reduces.
  * ``"row"`` — the rank's rows of K (the output projection ``wo`` and the
    FFN's ``down``), on the rank's slice of the input; the partial
    products are summed over the mesh (``_apply_row_parallel``).  Under
    w8a8 the result is bitwise the unsharded projection: the input is
    quantized with the global per-row absmax (``pmax`` of each rank's,
    K1's absmax and given-absmax modes), each rank's int32 partial (K2's
    int32-out mode) is summed exactly (``psum``), and K2's epilogue runs
    once on the sum.  Under ``none`` and ``w8`` the f32 partials are
    summed in rank order and cast after the sum: not the unsharded bits
    (another summation order), the same bits on every rank.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantization import QTensor, k_major, quantize
from repro_torch.kernels.quant_act.ops import (quant_act, quant_act_glu,
                                               row_absmax)
from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                  tiled_matmul,
                                                  tiled_matmul_int32)

QuantMode = str  # "none" | "w8" | "w8a8"
VALID_MODES = ("none", "w8", "w8a8")


class Linear(nn.Module):
    """y = x @ W (+ b): master ``w`` (K, N) or quantized ``w_q``, bias ``b``.
    ``shard`` (None, ``"column"`` or ``"row"``) and ``mesh`` are set by
    ``bridge.shard_model`` on a rank's slice."""

    def __init__(self, w: torch.Tensor | None = None,
                 w_q: QTensor | None = None, b: torch.Tensor | None = None):
        super().__init__()
        self.shard: str | None = None
        self.mesh = None
        if (w is None) == (w_q is None):
            raise ValueError("Linear takes exactly one of w and w_q")
        self.register_buffer("w", w)
        self.register_buffer("w_q_values", None if w_q is None else w_q.values)
        self.register_buffer("w_q_scale", None if w_q is None else w_q.scale)
        self.bits = 8 if w_q is None else w_q.bits
        self.register_buffer("b", b)

    @property
    def w_q(self) -> QTensor | None:
        if self.w_q_values is None:
            return None
        return QTensor(self.w_q_values, self.w_q_scale, self.bits)


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int, *,
                use_bias: bool = False, scale: float | None = None) -> Linear:
    """Truncated-normal fan-in init, f32 master weights, drawn on the
    generator's device (the CPU in ``init_model``)."""
    std = scale if scale is not None else in_dim ** -0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    b = torch.zeros((out_dim,), device=generator.device) if use_bias else None
    return Linear(w=w * std, b=b)


def weight_channel_axes(w: torch.Tensor) -> tuple[int, ...]:
    """Per-output-channel scale axes, stack-aware: (K, N) → (1,);
    layer-stacked (L, K, N) → (0, 2) — per (layer, out-channel)."""
    return tuple(range(w.dim() - 2)) + (w.dim() - 1,)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Per-output-channel int8 quantization of a (..., K, N) weight, its
    values K-major (``k_major``)."""
    q = quantize(w, channel_axes=weight_channel_axes(w))
    return QTensor(k_major(q.values), q.scale, q.bits)


def quantize_linear(params: Linear) -> Linear:
    """Offline int8 weight quantization (per output channel), keeps bias
    f32."""
    b = params.b.float() if params.b is not None else None
    return Linear(w_q=quantize_weight(params.w), b=b)


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    if bias is None:
        return y
    return y + bias.to(y.dtype)


def apply_linear(params: Linear, x: torch.Tensor, *,
                 mode: QuantMode = "none", out_dtype=None) -> torch.Tensor:
    """y = x @ W (+ b) under the configured quantization mode.

    Takes master weights for 'none' and 'w8' (quantized on the fly) or
    quantized weights for 'w8' and 'w8a8'.
    """
    if mode not in VALID_MODES:
        raise ValueError(f"mode must be one of {VALID_MODES}, got {mode!r}")
    out_dtype = out_dtype or x.dtype
    if params.shard == "row":
        return _apply_row_parallel(params, x, mode=mode, out_dtype=out_dtype)
    bias = params.b

    if mode == "none":
        y = x @ params.w.to(x.dtype)
        return _add_bias(y, bias).to(out_dtype)

    if mode == "w8":
        y = x @ _weight_q(params).dequantize(x.dtype)
        return _add_bias(y, bias).to(out_dtype)

    # w8a8 — the paper's path.
    return _apply_w8a8(params, quant_act(_rows(x)), x.shape[:-1], out_dtype)


def apply_linears(projections: Sequence[Linear], x: torch.Tensor, *,
                  mode: QuantMode = "none", out_dtype=None
                  ) -> list[torch.Tensor]:
    """``apply_linear`` of each projection on the same input x.  Under
    w8a8 one K1 of x serves them all (the gated FFN's gate and up): the
    int8 values and scales are those each call would make, so the outputs
    are bitwise ``apply_linear``'s."""
    if mode != "w8a8" or any(p.shard == "row" for p in projections):
        return [apply_linear(p, x, mode=mode, out_dtype=out_dtype)
                for p in projections]
    xq = quant_act(_rows(x))
    return [_apply_w8a8(p, xq, x.shape[:-1], out_dtype or x.dtype)
            for p in projections]


def apply_linear_swiglu(params: Linear, gate: torch.Tensor,
                        up: torch.Tensor, *, mode: QuantMode = "none",
                        out_dtype=None) -> torch.Tensor:
    """``apply_linear(params, F.silu(gate) * up, mode=mode)``: the SwiGLU
    FFN's down projection.  Under w8a8 K1's SwiGLU mode (``quant_act_glu``)
    quantizes the product in one launch without writing it out, bitwise
    ``quant_act`` of it."""
    if mode != "w8a8":
        return apply_linear(params, F.silu(gate) * up, mode=mode,
                            out_dtype=out_dtype)
    if params.shard == "row":
        return _apply_row_parallel(params, gate, up, mode=mode,
                                   out_dtype=out_dtype or gate.dtype)
    hq = quant_act_glu(_rows(gate), _rows(up))
    return _apply_w8a8(params, hq, gate.shape[:-1], out_dtype or gate.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., K) as the (M, K) contiguous matrix K1 quantizes by row."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def _weight_q(params: Linear) -> QTensor:
    """The quantized weights: stored, or quantized on the fly from ``w``."""
    wq = params.w_q
    return wq if wq is not None else quantize_weight(params.w)


def _apply_w8a8(params: Linear, xq: QTensor, lead: torch.Size, out_dtype
                ) -> torch.Tensor:
    """The int8 GEMM with its dequant and bias epilogue (kernel K2) on an
    activation K1 has quantized per row, reshaped to (*lead, N)."""
    bias = params.b
    y = tiled_matmul(xq, _weight_q(params),
                     bias.float() if bias is not None else None,
                     out_dtype=out_dtype)
    return y.reshape(*lead, y.shape[-1])


def _apply_row_parallel(params: Linear, x: torch.Tensor,
                        up: torch.Tensor | None = None, *, mode: QuantMode,
                        out_dtype) -> torch.Tensor:
    """A row-parallel projection on this rank's slice of its input (with
    ``up``, under w8a8: of the SwiGLU product ``F.silu(x) * up``), summed over
    ``params.mesh``; the bias is added once, after the sum (module
    docstring)."""
    mesh = params.mesh
    lead = x.shape[:-1]
    if mode == "w8a8":
        rows = _rows(x)
        wq = _weight_q(params)
        if up is None:
            absmax = mesh.pmax(row_absmax(rows))
            xq = quant_act(rows, absmax=absmax)
        else:
            ups = _rows(up)
            absmax = mesh.pmax(row_absmax(rows, ups))
            xq = quant_act_glu(rows, ups, absmax=absmax)
        acc = mesh.psum(tiled_matmul_int32(xq, wq))
        bias = params.b.float() if params.b is not None else None
        y = int8_epilogue(acc, xq.scale, wq, bias, out_dtype=out_dtype)
        return y.reshape(*lead, y.shape[-1])
    w = (params.w if mode == "none"
         else _weight_q(params).dequantize(torch.float32))
    y = mesh.psum(x.float() @ w.float())
    return _add_bias(y, params.b).to(out_dtype)
