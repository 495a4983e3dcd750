"""AdamW with decoupled weight decay + global-norm clipping.

The JAX package's arithmetic, leaf by leaf: gradients in f32, clipped by
``min(1, clip_norm / (global_norm + 1e-12))``; the moments ``b1 m + (1 -
b1) g`` and ``b2 v + (1 - b2) g^2``; bias corrections ``1 / (1 - b**c)``
with ``c`` the step count as an f32 tensor; the step ``(m * mhat) /
(sqrt(v * vhat) + eps) + weight_decay * p``, and ``p - lr * step`` cast to
the leaf's dtype.  Every division is tensor by tensor (on CUDA a division
by a Python scalar is a multiply by its reciprocal), and every square root
correctly rounded (``_sqrt``).  Under ``jax.jit`` XLA fuses ``b1 m + (1 -
b1) g`` into one FMA, so a jitted JAX step may differ in the moments' last
bits; eager, the arithmetic is the same bit for bit.

A tree here is a dict of tensors in ``repro_torch.tree.jax_order`` (the
train step's parameter dicts): ``global_norm`` sums over it in that order.
Unlike the JAX package, ``update`` writes the new parameters and moments
into the given tensors: the ZeRO-1 state of a 3B model is 43 GB, and a
second copy of it would not fit on the card.  Each gradient is cast to
f32 as its leaf is updated, not all at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    count: torch.Tensor              # int32, 0-d


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params: dict) -> AdamWState:
        """Zero moments of each leaf's shape, dtype and device."""
        dev = next(iter(params.values())).device
        return AdamWState(
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return _f32(self.learning_rate, count)

    def update(self, grads: dict, state: AdamWState, params: dict):
        """Returns (params, state, gnorm), the parameters and moments
        updated in place, the count advanced and gnorm the gradients'
        global norm before clipping."""
        count = state.count + 1
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.minimum(
                _f32(1.0, gnorm),
                _f32(self.clip_norm, gnorm) / (gnorm + 1e-12))
        b1, b2 = self.b1, self.b2
        c = count.float()
        one = _f32(1.0, c)
        mu_hat_scale = one / (1 - torch.pow(_f32(b1, c), c))
        nu_hat_scale = one / (1 - torch.pow(_f32(b2, c), c))
        lr = self._lr(count)
        for name, p in params.items():
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m, v = state.mu[name], state.nu[name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * (g * g))
            step = (m * mu_hat_scale) / (_sqrt(v * nu_hat_scale)
                                         + self.eps)
            step = step + self.weight_decay * p
            p.copy_((p - lr * step).to(p.dtype))
            del g, step
        state.count = count
        return params, state, gnorm


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root.  PyTorch's vectorized CPU
    sqrt is not (about 0.6% of values land an ulp off); the root of the
    f32 value taken in f64 and rounded to f32 is.  CUDA's f32 sqrt is
    IEEE's."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the dict's order, of each leaf's
    f32 sum of squares."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return _sqrt(total)
