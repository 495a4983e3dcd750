"""Losses: next-token cross-entropy (+ z-loss)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss_coef: float = 0.0, with_accuracy: bool = False):
    """logits (B, S, V) f32; targets (B, S) int.  Mean over tokens.

    Returns (loss, metrics): ``ce`` (the mean of logsumexp minus the true
    logit), ``ppl_proxy`` (exp of it, capped at e^20), and with
    ``z_loss_coef`` the ``z_loss`` (its coefficient times the mean squared
    logsumexp), which the loss includes.  ``with_accuracy`` is eval-only:
    the argmax materializes a logits-sized integer buffer, which at 100k+
    vocab is GiB-scale — keep it out of the train step.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - true_logit
    loss = nll.mean()
    metrics = {"ce": loss,
               "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    if with_accuracy:
        metrics["accuracy"] = (logits.argmax(-1) == targets).float().mean()
    if z_loss_coef:
        zl = z_loss_coef * torch.mean(lse ** 2)
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
