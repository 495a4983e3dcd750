"""int8 gradient compression with error feedback.

The paper's insight at the distributed level: quarter the bytes a
bandwidth-limited interconnect must move by quantizing gradients to int8
with a shared scale.  Gradients are quantized per leaf (per-tensor
symmetric absmax — the paper's scheme), and the quantization residual is
carried to the next step (error feedback, Seide et al. 2014) so
convergence is preserved.  As in the JAX package under GSPMD, this is a
pre-optimizer transform of the global (already reduced) gradient whose
int8 round trip models the wire format, with the residual kept in f32;
``wire_bytes`` counts what the wire would carry.  No collective moves
int8: a sum of int8 shares is another function than the reference's.

A leaf is one leaf of the JAX package's tree: the layers of a stacked
leaf share one scale (``repro_torch.tree.leaf_groups``), so with
``stochastic=False`` the values are the JAX package's bit for bit.  The
stochastic rounding noise comes from a ``torch.Generator`` and cannot match
``jax.random``'s bits.

Over a mesh (``mesh=``, ``specs=``: each gradient is this rank's block of
the whole leaf, placed as ``TrainPlacement.grad_specs`` says) a rank
computes its block of what one device computes on the whole gradient:
each leaf's absmax is the maximum over every rank (one all-reduce of all
the leaves' maxima a call; a maximum is exact in any order, so the scale
is one device's bit for bit), and every rank draws the noise of each
name's whole shape from the generator (seeded alike on every rank), in
``leaf_groups`` order, and keeps its block.  The noise is then the bits
one device draws, and a replicated leaf gets the same bits on every rank.
The noise's transient is the largest name's whole shape in f32
(qwen2.5-3b's embedding: 151936 x 2048 x 4 B = 1.24 GB a rank).  The
residual stays in the gradients' layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import qmax_for_bits
from repro_torch.launch.sharding import entry_axes, take_shard
from repro_torch.tree import leaf_groups


def _whole_shapes(grads: dict, specs: dict, mesh) -> dict:
    """Each gradient's whole shape from its block and its placement;
    raises where the placements do not fit the gradients."""
    missing = [n for n in grads if n not in specs]
    if missing:
        raise ValueError(f"no placement for the gradients {missing[:4]}"
                         f"{' ...' if len(missing) > 4 else ''}")
    out = {}
    for name, g in grads.items():
        spec = specs[name]
        if len(spec) != g.dim():
            raise ValueError(f"{name}: placement {spec} for a gradient of "
                             f"shape {tuple(g.shape)}")
        out[name] = tuple(n * mesh.extent(entry_axes(e)) if e else n
                          for n, e in zip(g.shape, spec))
    return out


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    bits: int = 8
    stochastic: bool = True

    def init_residual(self, params: dict) -> dict:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    def compress_decompress(self, grads: dict, residual: dict,
                            generator: torch.Generator | None = None, *,
                            mesh=None, specs: dict | None = None):
        """Returns (wire_grads, new_residual).

        wire_grads = dequant(quant(grads + residual)); the difference is the
        new residual.  This is exactly what would cross the interconnect.
        The stochastic rounding draws its noise from ``generator`` (on the
        gradients' device).  With ``mesh`` (of more than one rank) and
        ``specs`` (each name's placement) the gradients and the residual
        are this rank's blocks, and so are the results (module docstring).
        """
        qmax = qmax_for_bits(self.bits)
        sharded = mesh is not None and mesh.world > 1
        if sharded and specs is None:
            raise ValueError("a mesh of more than one rank needs specs=")
        if specs is not None and mesh is None:
            raise ValueError("specs= without a mesh")
        whole = (_whole_shapes(grads, specs, mesh) if sharded
                 else {n: tuple(g.shape) for n, g in grads.items()})
        groups = leaf_groups(grads)
        # g + residual in f32, held in the new residual's buffer; the
        # quantized values are taken out of it below
        new_res = {}
        maxima = []
        for _, names in groups:
            for n in names:
                new_res[n] = grads[n].float() + residual[n]
            maxima.append(torch.stack([new_res[n].abs().max()
                                       for n in names]).max())
        absmax = torch.stack(maxima)
        if sharded:
            absmax = mesh.pmax(absmax, ("data", "model"))
        scales = torch.where(absmax <= 1e-30, torch.ones_like(absmax),
                             absmax / torch.full_like(absmax, qmax))
        # in place: a name's transient is its block (q) and, when
        # stochastic, its whole noise; each op rounds as its
        # out-of-place form does
        out = {}
        for i, (_, names) in enumerate(groups):
            scale = scales[i]
            for n in names:
                x = new_res[n]
                q = x / scale
                if self.stochastic:
                    noise = torch.rand(whole[n], generator=generator,
                                       device=q.device)
                    if sharded:
                        noise = take_shard(noise, specs[n], mesh)
                    q.add_(0.5).add_(noise.sub_(0.5)).floor_()
                    del noise
                else:
                    q.round_()
                deq = q.clamp_(-qmax, qmax).mul_(scale)
                out[n] = deq.to(grads[n].dtype)
                x.sub_(deq)
        return out, new_res

    def wire_bytes(self, grads: dict) -> int:
        """Bytes on the wire per all-reduce with compression: one int8 a
        value and one f32 scale a JAX leaf."""
        return (sum(x.numel() for x in grads.values())
                + 4 * len(leaf_groups(grads)))
