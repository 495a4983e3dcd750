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

Over a mesh (``bridge.shard_model`` sets ``MoE.mesh``; the serving rules
of ``launch/sharding.py`` place the experts, ``router`` stays replicated)
the JAX package's ``shard_map`` branches (``_dispatch_compute(ep_axis=)``)
become the rank's program.  Routing runs whole on every rank (its input,
the residual stream, is the same bits on every rank).  Which dim of the
stacks the rank holds decides its program:

  * **E-split** (the expert dim divides the ``model`` axis: qwen3-moe's
    128 experts on 2 or 4 ranks).  The rank dispatches to its own slice of
    experts only; expert ids stay global, offset by the rank's first
    expert (the reference's ``e_off``), so capacity, the kept copies and
    the drops are the unsharded model's, and a copy routed to another
    rank's expert is masked out.  Each copy (token, j) lives on exactly
    one rank, so the rank-order sum (``Mesh.psum``) of the masked per-copy
    contributions, (B, S, k, D), is exact, and the ascending-expert-id
    combine then runs on that sum as on one device: the output is
    **bitwise** the unsharded port's.  The reference sums the (B, S, D)
    output once instead (one psum); the port moves k times those bytes to
    keep the order: per layer and rank, at qwen3-moe's k = 8, D = 2048 in
    bf16, 131,072 bytes for a decode step of 4 rows (16,384 for the
    reference's psum) and 33,554,432 for a prefill of 4 x 256 tokens
    (4,194,304); gloo carries bf16 as f32, twice that.
  * **``expert_mlp`` split** (an expert count that does not divide the
    axis: granite's 40 on 16, or 6 experts on 4 ranks).  ``gate`` and
    ``up`` hold the rank's columns and ``down`` its rows, so the rank's
    combine is its share of the output, and the (B, S, D) shares are
    summed in rank order.  This is not bitwise (the F sum is split): the
    f32 output is within 1e-6 relative error of one device's
    (``tests/test_torch_moe_mesh.py``).  The reference's EP branch pads
    such a stack with dummy experts and splits it E-wise; both compute
    the same function, and the port computes on the slice it stores, so
    a rank's bytes stay those of its placement.
  * **Neither divides**: the rank computes every expert, as one device.

On a ``("data", "model")`` mesh each data rank holds its own rows of the
batch (``launch.sharding.shard_batch``) and dispatches them alone, as
the reference's data-parallel branch does: per-sequence capacity makes
that the global computation, and tokens never leave their rank.  The
load-balance loss's means ``me`` and ``fe`` are the global batch's: each
is averaged over ``data`` before their product, ``me`` through an
all-reduce that carries its gradient (``launch.mesh.copy_to`` then
``reduce_from``: the sum forward and backward, since the train step
averages each data rank's gradients).  Under autograd the dispatched
input and the gates enter the rank's experts through ``copy_to``, so
their gradients are summed over ``model``.  ``moe_impl="local"`` on a
mesh of more than one rank raises: it asks for GSPMD's global placement,
which the port does not have.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantization import QTensor
from repro_torch.core.quantized_linear import Linear, init_linear
from repro_torch.launch.mesh import copy_to, reduce_from
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

    def stack_shape(self, name: str = "gate") -> tuple[int, ...]:
        """The shape of the stack this module holds (a rank's slice on a
        mesh)."""
        values = getattr(self, name + "_values")
        return tuple((getattr(self, name) if values is None
                      else values).shape)


class MoE(nn.Module):
    """The float ``router`` (D, E), the ``experts`` and, with shared
    experts, a dense ``shared`` FFN.  ``mesh`` is set by
    ``bridge.shard_model``."""

    def __init__(self, router: Linear, experts: Experts,
                 shared: FFN | None = None):
        super().__init__()
        self.router = router
        self.experts = experts
        self.shared = shared
        self.mesh = None


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


def route(router: Linear, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """Returns (gates (B, S, k) in x's dtype, idx (B, S, k), aux): the top
    k of the router's softmax, ties to the lower expert id.  On a mesh
    with a ``data`` axis of more than one rank the load-balance loss is
    the global batch's (module docstring)."""
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
    if mesh is not None and mesh.data > 1:
        n = torch.full((), mesh.data, dtype=torch.float32, device=x.device)
        me = reduce_from(mesh, copy_to(mesh, me, "data"), "data") / n
        fe = mesh.psum(fe, "data") / n
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


def _dispatch_compute(x, gates, idx, experts: Experts, cfg: ModelConfig,
                      e_off: int = 0) -> torch.Tensor:
    """Sort-based capacity dispatch to the experts ``experts`` holds (global
    ids ``e_off`` on), their FFNs, and each copy's weighted output: x (B,
    S, D); gates / idx (B, S, k) → (B, S, k, D), a token's copies in
    ascending expert id, zero where a copy was dropped or routed to an
    expert held elsewhere.  ``_combine`` adds them."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_local = experts.stack_shape()[0]
    c = _capacity(cfg, s)
    dev = x.device
    tk = s * k
    # the copies sorted by expert, each expert's in token order; copy i of
    # the flat (S * k) order is token i // k's.  Counts and starts are over
    # every expert: a copy's slot is the unsharded model's
    flat_e = idx.reshape(b, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(dim=-1) - counts                      # (B, E)

    # dispatch: slot p of expert e holds its p-th copy while p < its count;
    # an empty slot reads a zero row (token s); copies past c are dropped
    mine = slice(e_off, e_off + e_local)
    p = torch.arange(c, device=dev)
    q = (starts[:, mine, None] + p).clamp(max=tk - 1).reshape(b, e_local * c)
    tok = torch.where(p < counts[:, mine, None],
                      torch.gather(order // k, 1, q).reshape(b, e_local, c),
                      s)
    xbuf = _rows(torch.cat([x, x.new_zeros((b, 1, d))], dim=1), tok)
    ybuf = expert_ffn(xbuf, experts, cfg).reshape(b, e_local * c, d)

    # each copy's slot in its expert (>= c: dropped), its copies in
    # ascending expert id, the order in which the reference's scatter-add
    # adds them
    pos_sorted = (torch.arange(tk, device=dev)
                  - torch.gather(starts, 1, torch.gather(flat_e, 1, order)))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    asc = torch.argsort(idx, dim=-1)
    pos = torch.gather(pos.reshape(b, s, k), -1, asc)           # (B, S, k)
    local = torch.gather(idx, -1, asc) - e_off
    live = (pos < c) & (local >= 0) & (local < e_local)
    slot = local.clamp(0, e_local - 1) * c + pos.clamp(max=c - 1)
    w = torch.gather(gates, -1, asc).to(x.dtype)[..., None]
    return torch.where(live[..., None], _rows(ybuf, slot) * w, 0)


def _combine(yk: torch.Tensor) -> torch.Tensor:
    """A token's k contributions (B, S, k, D) added one after another in
    the activation dtype, rounding after each."""
    y = torch.zeros_like(yk[:, :, 0])
    for j in range(yk.shape[2]):
        y = y + yk[:, :, j]
    return y


def expert_split(experts: Experts, cfg: ModelConfig) -> str | None:
    """Which dim of the stacks a rank holds a slice of: ``"experts"``,
    ``"expert_mlp"``, or None (every expert whole)."""
    e_local, _, f_local = experts.stack_shape()
    if e_local < cfg.n_experts:
        return "experts"
    if f_local < cfg.d_ff_expert:
        return "expert_mlp"
    return None


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) → (y, aux) with the load-balance loss in aux; on a
    mesh, the rank's program (module docstring)."""
    mesh = params.mesh
    if mesh is not None and mesh.world > 1 and cfg.moe_impl == "local":
        raise NotImplementedError(
            f"moe_impl='local' on a mesh of {mesh.world} ranks: it asks for "
            "the global dispatch GSPMD places in the JAX package, which the "
            "port does not have; use 'auto' or 'sharded' (the rank's "
            "expert-parallel and data-parallel dispatch)")
    gates, idx, aux = route(params.router, x, cfg, mesh)
    split = (None if mesh is None or mesh.size == 1
             else expert_split(params.experts, cfg))
    if split is None:
        y = _combine(_dispatch_compute(x, gates, idx, params.experts, cfg))
    else:
        # each rank's share of the gradients of the dispatched input and
        # the gates is summed over the mesh
        xe, ge = copy_to(mesh, x), copy_to(mesh, gates)
        if split == "experts":
            e_off = mesh.rank * params.experts.stack_shape()[0]
            yk = _dispatch_compute(xe, ge, idx, params.experts, cfg, e_off)
            y = _combine(reduce_from(mesh, yk))
        else:
            y = reduce_from(mesh, _combine(
                _dispatch_compute(xe, ge, idx, params.experts, cfg)))
    if params.shared is not None:
        y = y + apply_ffn(params.shared, x, cfg)
    return y, aux
