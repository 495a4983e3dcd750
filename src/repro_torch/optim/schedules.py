"""Learning-rate schedules (warmup + cosine / constant).

Each schedule maps the step count, an int tensor, to an f32 0-d tensor on
its device, by the JAX package's arithmetic: f32 operations, Python
constants folded first, and every division tensor by tensor (on CUDA a
division by a Python scalar is a multiply by its reciprocal).
"""
from __future__ import annotations

import math

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / _f32(max(warmup_steps, 1), step)
        prog = torch.clamp((step - warmup_steps)
                           / _f32(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(_f32(math.pi, step) * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
