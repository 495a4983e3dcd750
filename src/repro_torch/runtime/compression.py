"""int8 gradient compression with error feedback.

The paper's insight at the distributed level: quarter the bytes a
bandwidth-limited interconnect must move by quantizing gradients to int8
with a shared scale.  Gradients are quantized per leaf (per-tensor
symmetric absmax — the paper's scheme), and the quantization residual is
carried to the next step (error feedback, Seide et al. 2014) so
convergence is preserved.  On one device this is a pre-optimizer gradient
transform whose int8 round trip models the wire format, with the residual
kept in f32.

A leaf is one leaf of the JAX package's tree: the layers of a stacked
leaf share one scale (``repro_torch.tree.leaf_groups``), so with
``stochastic=False`` the values are the JAX package's bit for bit.  The
stochastic rounding noise comes from a ``torch.Generator`` and cannot match
``jax.random``'s bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import qmax_for_bits
from repro_torch.tree import leaf_groups


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    bits: int = 8
    stochastic: bool = True

    def init_residual(self, params: dict) -> dict:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    def compress_decompress(self, grads: dict, residual: dict,
                            generator: torch.Generator | None = None):
        """Returns (wire_grads, new_residual).

        wire_grads = dequant(quant(grads + residual)); the difference is the
        new residual.  This is exactly what would cross the interconnect.
        The stochastic rounding draws its noise from ``generator`` (on the
        gradients' device).
        """
        qmax = qmax_for_bits(self.bits)
        out, new_res = {}, {}
        for _, names in leaf_groups(grads):
            g32 = {n: grads[n].float() + residual[n] for n in names}
            absmax = torch.stack([x.abs().max() for x in g32.values()]).max()
            scale = torch.where(absmax <= 1e-30, torch.ones_like(absmax),
                                absmax / torch.full_like(absmax, qmax))
            for n, x in g32.items():
                scaled = x / scale
                if self.stochastic:
                    noise = torch.rand(scaled.shape, generator=generator,
                                       device=scaled.device) - 0.5
                    q = torch.floor(scaled + 0.5 + noise)
                else:
                    q = torch.round(scaled)
                q = torch.clamp(q, -qmax, qmax)
                deq = q * scale
                out[n] = deq.to(grads[n].dtype)
                new_res[n] = x - deq
        return out, new_res

    def wire_bytes(self, grads: dict) -> int:
        """Bytes on the wire per all-reduce with compression: one int8 a
        value and one f32 scale a JAX leaf."""
        return (sum(x.numel() for x in grads.values())
                + 4 * len(leaf_groups(grads)))
