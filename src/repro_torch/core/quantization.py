"""Symmetric integer quantization — the paper's P4 mechanism.

Symmetric int8 quantization with zero-point 0 for weights and activations:
per-tensor, per-channel (weights) and per-row (activations) absmax scales,
carried in a ``QTensor`` of int8 ``values`` and a keepdims f32 ``scale``.
Values and scales match the JAX package's ``quantize`` bit for bit:
absmax in f32, scale 1.0 where absmax <= 1e-12, IEEE division, round half
to even (``torch.round``), clip to ±qmax.

``quantize_kv`` gives the int8 rows and scales of the paged KV cache.
``fake_quantize`` is the quantize-dequantize round trip with a
straight-through gradient (the QAT helper), and ``Calibrator`` the running
absmax (or its EMA) behind a fixed per-tensor scale.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["QTensor", "quantize", "dequantize", "qmax_for_bits",
           "quantize_kv", "k_major", "fake_quantize", "Calibrator"]


def qmax_for_bits(bits: int) -> int:
    """Symmetric integer range: ±(2^(bits-1) - 1), e.g. ±127 for int8."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    return (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: int8 ``values`` with broadcastable f32 ``scale``.

    ``scale`` has the same rank as ``values`` with size 1 on every axis that
    shares a scale (keepdims layout), so ``values.float() * scale``
    dequantizes with plain broadcasting.  ``bits`` is metadata: values are
    stored int8 regardless, clipped to the ±(2^(bits-1)-1) range.
    """

    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def _scale_for(x: torch.Tensor, channel_axes: Sequence[int], bits: int,
               eps: float = 1e-12) -> torch.Tensor:
    """Absmax symmetric scale, kept on ``channel_axes``, reduced elsewhere."""
    channel_axes = tuple(a % x.ndim for a in channel_axes)
    reduce_axes = tuple(a for a in range(x.ndim) if a not in channel_axes)
    absmax = x.float().abs()
    if reduce_axes:
        absmax = torch.amax(absmax, dim=reduce_axes, keepdim=True)
    qmax = qmax_for_bits(bits)
    # Guard all-zero rows/channels: scale 1 quantizes zeros to zeros exactly.
    # Tensor / tensor: on CUDA a division by a Python scalar becomes a
    # multiply by its reciprocal, one ulp off the IEEE quotient.
    return torch.where(absmax <= eps, torch.ones_like(absmax),
                       absmax / torch.full_like(absmax, qmax))


def quantize(x: torch.Tensor, *, channel_axes: Sequence[int] = (),
             bits: int = 8) -> QTensor:
    """Symmetric absmax quantization (zero-point 0, per the paper).

    ``channel_axes`` are the axes that KEEP independent scales:
      * weights ``(K, N)``  → ``channel_axes=(1,)``  (per output channel)
      * stacked weights ``(L, K, N)`` → ``(0, 2)``  (per layer and channel)
      * activations ``(M, K)`` → ``channel_axes=(0,)`` (per token/row)
      * ``()`` → per-tensor (the paper's fixed single scale)
    """
    scale = _scale_for(x, channel_axes, bits)
    qmax = qmax_for_bits(bits)
    q = torch.round(x.float() / scale)
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    return QTensor(values=q, scale=scale, bits=bits)


def k_major(values: torch.Tensor) -> torch.Tensor:
    """``values`` (..., K, N) stored K-major: the same (..., K, N) view of
    an (..., N, K)-contiguous copy.  Quantized weights rest in this layout
    because the int8 GEMM kernels read them so (wgmma takes 8-bit operands
    only K-major, and TMA cannot transpose bytes); ``.to()`` and
    ``copy.deepcopy`` keep it."""
    return values.transpose(-1, -2).contiguous().transpose(-1, -2)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (q.values.float() * q.scale).to(dtype)


def quantize_kv(x: torch.Tensor, *, bits: int = 8):
    """Quantize K/V rows for the int8 page pools: one absmax scale per
    vector on the trailing (head_dim) axis, i.e. per (token, kv-head).
    Returns ``(values int8, scales f32)`` with ``scales.shape ==
    x.shape[:-1]``, so ``values.float() * scales[..., None]``
    dequantizes."""
    q = quantize(x, channel_axes=tuple(range(x.ndim - 1)), bits=bits)
    return q.values, q.scale[..., 0]


class _FakeQuantize(torch.autograd.Function):
    """quantize → dequantize forward, the gradient passed straight through
    (the straight-through estimator)."""

    @staticmethod
    def forward(ctx, x, channel_axes, bits):
        return dequantize(quantize(x, channel_axes=channel_axes, bits=bits),
                          x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quantize(x: torch.Tensor, *, channel_axes: Sequence[int] = (),
                  bits: int = 8) -> torch.Tensor:
    """Quantize→dequantize with a straight-through gradient (QAT helper)."""
    return _FakeQuantize.apply(x, tuple(channel_axes), bits)


@dataclasses.dataclass
class Calibrator:
    """Running-absmax static calibration (the paper's 'careful
    calibration').

    Feed representative activation batches with ``observe``; ``scale`` then
    yields a fixed per-tensor scale usable for static (offline)
    quantization: the true running max, or with ``momentum`` an EMA of each
    batch's absmax (the first batch's absmax to start).
    """

    bits: int = 8
    momentum: float | None = None  # None = true max; else EMA of absmax
    _absmax: float = 0.0
    _steps: int = 0

    def observe(self, x: torch.Tensor) -> None:
        amax = float(x.float().abs().max())
        if self.momentum is None:
            self._absmax = max(self._absmax, amax)
        else:
            m = self.momentum
            self._absmax = amax if self._steps == 0 else (
                m * self._absmax + (1 - m) * amax)
        self._steps += 1

    @property
    def scale(self) -> float:
        if self._steps == 0:
            raise ValueError("Calibrator.observe was never called")
        amax = max(self._absmax, 1e-12)
        return amax / qmax_for_bits(self.bits)

    def quantize(self, x: torch.Tensor) -> QTensor:
        """Per-tensor int8 values of ``x`` at the calibrated scale (an f32
        keepdims scale of ones' shape), by IEEE division, half-to-even
        rounding and clipping to ±qmax, as ``quantize`` rounds."""
        s = torch.full((1,) * x.dim(), self.scale, dtype=torch.float32,
                       device=x.device)
        qmax = qmax_for_bits(self.bits)
        q = torch.clamp(torch.round(x.float() / s), -qmax, qmax)
        return QTensor(values=q.to(torch.int8), scale=s, bits=self.bits)
