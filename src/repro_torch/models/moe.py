"""Mixture-of-Experts FFN: top-k routing, per-sequence capacity dispatch.

The counterpart of the JAX package's ``models/moe.py`` (its local path):
an f32 router, softmax, top-k (renormalised under ``router_norm_topk``),
the Switch load-balance loss, a sort-based dispatch into an
``(B, E, C, D)`` buffer with per-sequence capacity C (overflow copies
dropped, underflow slots zero), three batched expert einsums
``(B, E, C, D) × (E, D, F)``, and a combine that adds each token's
weighted expert outputs.

Quantized experts (``quantize_model_params(..., quantize_experts=True)``)
are **w8**: int8 values with scales per (expert, output channel),
dequantized in the activation dtype, ``values.to(dtype) *
scale.to(dtype)``, one layer at a time in each forward, then a plain
product, as the reference's code does (its module docstring says the
expert GEMMs run int8 under w8a8; its code dequantizes).  Neither package
has a kernel of its own in this block.  At S = 1 every expert computes its
C = 8 slots (``_capacity``), so a decode step reads every expert's
weights.

Matching the reference where torch differs from XLA:
  * top-k is the first k of a stable descending sort: ties go to the lower
    expert id, as ``jax.lax.top_k`` does;
  * a dropped copy writes to an extra slot C that is sliced off (XLA's
    ``mode="drop"``);
  * the combine adds a token's k contributions one after another in the
    activation dtype, in ascending expert id (the order XLA's scatter-add
    adds them in), with no atomics: the result is deterministic and the
    same on the card and the CPU.

The expert-parallel and data-parallel (``shard_map``) branches need a
mesh.  The port's meshes (``launch/mesh.py``) serve the dense attention
families so far; MoE layers under a mesh, and these branches, are the
rest of ROADMAP queue 1, item 13 (``bridge.shard_model`` refuses an MoE
model).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantization import QTensor
from repro_torch.core.quantized_linear import Linear, init_linear
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import _ACT, FFN, apply_ffn, init_ffn


class Experts(nn.Module):
    """The routed experts' stacked weights: ``gate`` and ``up`` (E, D, F),
    ``down`` (E, F, D), each float or a ``QTensor`` of int8 values in the
    same layout with (E, 1, N) f32 scales."""

    NAMES = ("gate", "up", "down")

    def __init__(self, gate, up, down):
        super().__init__()
        self.bits = 8
        for name, w in zip(self.NAMES, (gate, up, down)):
            quantized = isinstance(w, QTensor)
            if quantized:
                self.bits = w.bits
            self.register_buffer(name, None if quantized else w)
            self.register_buffer(name + "_values",
                                 w.values if quantized else None)
            self.register_buffer(name + "_scale",
                                 w.scale if quantized else None)

    def weight(self, name: str) -> torch.Tensor | QTensor:
        values = getattr(self, name + "_values")
        if values is None:
            return getattr(self, name)
        return QTensor(values, getattr(self, name + "_scale"), self.bits)


class MoE(nn.Module):
    """The float ``router`` (D, E), the ``experts`` and, with shared
    experts, a dense ``shared`` FFN."""

    def __init__(self, router: Linear, experts: Experts,
                 shared: FFN | None = None):
        super().__init__()
        self.router = router
        self.experts = experts
        self.shared = shared


def _expert_stack(generator, shape, fan_in):
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(fan_in ** -0.5)


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> MoE:
    """Truncated-normal fan-in init, f32, drawn on the generator's device;
    the ``down`` stack further scaled by 1 / sqrt(n_layers)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    router = init_linear(generator, d, e)
    gate = _expert_stack(generator, (e, d, f), d)
    up = _expert_stack(generator, (e, d, f), d)
    down = _expert_stack(generator, (e, f, d), f).div_(
        max(cfg.n_layers, 1) ** 0.5)
    shared = None
    if cfg.n_shared_experts:
        shared = init_ffn(generator, cfg,
                          d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return MoE(router, Experts(gate, up, down), shared)


def _capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert for a sequence of ``s`` tokens: ceil(s·k/E ·
    capacity_factor) rounded up to 8, but no more than max(s, top_k)."""
    c = math.ceil(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = max(8, -(-c // 8) * 8)
    return min(c, max(s, cfg.top_k))


def route(router: Linear, x: torch.Tensor, cfg: ModelConfig):
    """Returns (gates (B, S, k) in x's dtype, idx (B, S, k), aux): the top
    k of the router's softmax, ties to the lower expert id."""
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ router.w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if cfg.router_norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    # the load-balance loss (Switch eq. 4): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    return gates.to(x.dtype), idx, {"load_balance_loss": e * (me * fe).sum()}


def expert_weight(experts: Experts, name: str, dtype) -> torch.Tensor:
    """One stack in ``dtype``; quantized values dequantized in it:
    ``values.to(dtype) * scale.to(dtype)``, computed as ``values *
    scale.to(dtype)`` in one pass (an int8 value is exact in bf16 and f32,
    and the product of the two is rounded once either way: bitwise the
    same)."""
    w = experts.weight(name)
    if isinstance(w, QTensor):
        return w.values * w.scale.to(dtype)
    return w.to(dtype)


def expert_ffn(xbuf: torch.Tensor, experts: Experts, cfg: ModelConfig
               ) -> torch.Tensor:
    """The experts on their slots: (B, E, C, D) → (B, E, C, D)."""
    act = _ACT[cfg.ffn_type]
    wg, wu, wd = (expert_weight(experts, name, xbuf.dtype)
                  for name in Experts.NAMES)
    h = act(torch.einsum("becd,edf->becf", xbuf, wg)) \
        * torch.einsum("becd,edf->becf", xbuf, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def _rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[b, index[b, ...]]`` for t (B, N, D): one gather of rows."""
    b, n, d = t.shape
    flat = index + n * torch.arange(b, device=t.device).view(
        (b,) + (1,) * (index.dim() - 1))
    return t.reshape(b * n, d).index_select(0, flat.reshape(-1)).reshape(
        *index.shape, d)


def _dispatch_compute(x, gates, idx, experts: Experts, cfg: ModelConfig):
    """Sort-based capacity dispatch, the expert FFNs and the combine, per
    sequence.  x (B, S, D); gates / idx (B, S, k)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(cfg, s)
    dev = x.device
    tk = s * k
    # the copies sorted by expert, each expert's in token order; copy i of
    # the flat (S * k) order is token i // k's
    flat_e = idx.reshape(b, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(dim=-1) - counts                      # (B, E)

    # dispatch: slot p of expert e holds its p-th copy while p < its count;
    # an empty slot reads a zero row (token s); copies past c are dropped
    p = torch.arange(c, device=dev)
    q = (starts[..., None] + p).clamp(max=tk - 1).reshape(b, e * c)
    tok = torch.where(p < counts[..., None],
                      torch.gather(order // k, 1, q).reshape(b, e, c), s)
    xbuf = _rows(torch.cat([x, x.new_zeros((b, 1, d))], dim=1), tok)
    ybuf = expert_ffn(xbuf, experts, cfg).reshape(b, e * c, d)

    # combine: each copy's slot in its expert (>= c: dropped); a token's
    # copies are added in ascending expert id, the order in which the
    # reference's scatter-add adds them, rounding in x's dtype after each
    pos_sorted = (torch.arange(tk, device=dev)
                  - torch.gather(starts, 1, torch.gather(flat_e, 1, order)))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    asc = torch.argsort(idx, dim=-1)
    pos = torch.gather(pos.reshape(b, s, k), -1, asc)           # (B, S, k)
    slot = torch.gather(idx, -1, asc) * c + pos.clamp(max=c - 1)
    w = torch.gather(gates, -1, asc).to(x.dtype)[..., None]
    yk = torch.where((pos < c)[..., None], _rows(ybuf, slot) * w, 0)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + yk[:, :, j]
    return y


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) → (y, aux) with the load-balance loss in aux."""
    if cfg.moe_impl == "sharded":
        raise NotImplementedError(
            "moe_impl='sharded' (the expert- and data-parallel dispatch): "
            "MoE under a mesh is ROADMAP queue 1, item 13 (the port's "
            "meshes serve the dense attention families so far)")
    gates, idx, aux = route(params.router, x, cfg)
    y = _dispatch_compute(x, gates, idx, params.experts, cfg)
    if params.shared is not None:
        y = y + apply_ffn(params.shared, x, cfg)
    return y, aux
