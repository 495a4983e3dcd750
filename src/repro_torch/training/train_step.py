"""Train step: loss → grad → (optional int8-compressed gradients) → AdamW.

The JAX package's ``make_train_step``: microbatched gradient accumulation
(f32 sums over microbatches, then divided by their count), the optional
gradient compressor hook, the ZeRO-1 state layout for bf16 configs and
the ``grad_norm`` and ``lr`` metrics.  On one device the JAX package's
``shard_like_params`` is the identity, and so it is absent here.

The port's weights are buffers of the ``Model``'s modules, not
``nn.Parameter``s.  A parameter tree here is a dict of the model's
floating-point buffers by name, in ``repro_torch.tree.jax_order`` (the
order of the JAX tree's leaves, each layer-stacked leaf's layers in
order).  Gradients are taken against leaves bound into the model for one
forward and backward (``value_and_grad``): the compute copy's own tensors,
or their bf16 casts, whose backward brings the gradient back to f32, as
the JAX package's cast inside the loss does.

Unlike the JAX package's pure step, ``train_step`` updates the state in
place and returns it: qwen2.5-3b's ZeRO-1 state is 43 GB, and a second
copy would not fit on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, apply_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.training.losses import cross_entropy
from repro_torch.tree import is_stacked, jax_order


def trainable(model: Model) -> dict[str, torch.Tensor]:
    """The model's parameter tree: its floating-point buffers by name, in
    JAX leaf order.  Raises on int8 (quantized) weights, which have no
    gradient: train a model of master weights."""
    named = dict(model.named_buffers())
    if any(not t.is_floating_point() for t in named.values()):
        raise NotImplementedError(
            "the model holds int8 (quantized) weights, which have no "
            "gradient; train its master weights (quantize for serving)")
    return {n: named[n] for n in jax_order(named)}


def _set_buffer(model: Model, name: str, tensor: torch.Tensor) -> None:
    prefix, _, attr = name.rpartition(".")
    setattr(model.get_submodule(prefix) if prefix else model, attr, tensor)


@contextlib.contextmanager
def bound(model: Model, tensors: dict[str, torch.Tensor]):
    """``tensors`` in place of the model's buffers of those names, put back
    on exit."""
    old = dict(model.named_buffers())
    for name, t in tensors.items():
        _set_buffer(model, name, t)
    try:
        yield model
    finally:
        for name in tensors:
            _set_buffer(model, name, old[name])


def _compute_cast(params: dict, dtype) -> dict:
    """Cast the f32 leaves whose JAX leaf has ≥ 2 dimensions to the compute
    dtype; the other leaves (the final norm's scale, the hybrid family's
    shared-block norms and biases) stay f32, as in the JAX package, where a
    per-layer norm scale or bias is a 2-D (layer, width) leaf and is cast.
    The cast is differentiable: its backward brings the gradient back to
    f32."""
    return {n: p.to(dtype) if p.dim() + is_stacked(n) >= 2
            and p.dtype == torch.float32 else p for n, p in params.items()}


@dataclasses.dataclass
class TrainState:
    """Training state.

    ZeRO-1 layout (bf16 configs): ``params`` is the model holding the bf16
    COMPUTE copy of the leaves ``_compute_cast`` casts (the others stay f32
    and are the master's own tensors), and ``master`` the f32 master
    weights beside the
    AdamW moments; the optimizer updates the master and the step refreshes
    the compute copy from it.  f32 configs keep the classic layout: master
    is None, and the model's f32 buffers are the parameters.
    """
    params: Model
    opt_state: AdamWState
    step: torch.Tensor               # int32, 0-d
    master: dict | None = None

    @classmethod
    def create(cls, model: Model, optimizer: AdamW,
               zero1: bool = False) -> "TrainState":
        """The state of ``model``'s f32 weights.  With ``zero1`` the model's
        own f32 tensors become the master and the buffers ``_compute_cast``
        casts are replaced by their bf16 compute copies (the model is the
        compute copy from then on)."""
        params = trainable(model)
        dev = next(iter(params.values())).device
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if not zero1:
            return cls(model, optimizer.init(params), step)
        for name, t in _compute_cast(params, torch.bfloat16).items():
            _set_buffer(model, name, t)
        return cls(model, optimizer.init(params), step, master=params)


def make_loss_fn(cfg: ModelConfig, lb_coef: float = 0.01,
                 z_loss_coef: float = 1e-4):
    """loss_fn(model, batch) -> (loss, metrics) over the model's buffers
    as bound: next-token cross-entropy (+ z-loss) of the logits, over the
    text tail for the vision family (its patches come first), plus
    ``lb_coef`` times the MoE load-balance loss averaged over the layers;
    an encoder-decoder takes the batch's ``encoder_frames``."""
    def loss_fn(model: Model, batch: dict):
        extra = {}
        if cfg.frontend == "vision":
            extra["frontend_embeds"] = batch["frontend_embeds"]
        if cfg.is_encoder_decoder:
            extra["encoder_frames"] = batch["encoder_frames"]
        logits, _, aux = apply_model(model, batch["inputs"], cfg, **extra)
        targets = batch["targets"]
        if cfg.frontend == "vision":     # loss only over the text tail
            logits = logits[:, -targets.shape[1]:, :]
        loss, metrics = cross_entropy(logits, targets, z_loss_coef)
        if cfg.is_moe:
            lb_sum = aux["load_balance_loss"]
            lb = lb_sum / torch.full_like(lb_sum, cfg.n_layers)
            loss = loss + lb_coef * lb
            metrics["load_balance"] = lb
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, model: Model, params: dict, batch: dict, *,
                   cast: bool = False):
    """(grads, metrics): the gradients of ``loss_fn(model, batch)`` with
    respect to ``params`` (a parameter tree), each in its leaf's dtype (a
    zero tensor for a leaf the loss does not reach), and the metrics
    detached.  ``cast`` runs the forward on the bf16 casts of the leaves
    ``_compute_cast`` casts.  The leaves stay bound through the
    backward, which recomputes the remat'd blocks from them."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    use = _compute_cast(leaves, torch.bfloat16) if cast else leaves
    with bound(model, use):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(leaves[n]) if g is None else g
             for n, g in zip(leaves, grads)}
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    microbatches: int = 1, lb_coef: float = 0.01,
                    z_loss_coef: float = 1e-4, compressor=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``compressor``: optional callable on the (accumulated) gradient tree
    before the optimizer, e.g. ``GradCompressor.compress_decompress`` with
    its error-feedback residual carried by the caller.
    """
    loss_fn = make_loss_fn(cfg, lb_coef, z_loss_coef)
    bf16 = cfg.dtype == "bfloat16"

    def accumulated(model, params, batch):
        # params cast to bf16 outside the microbatch loop (by the caller),
        # the accumulation in f32
        grads, history = None, []
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                               *v.shape[1:])[i] for k, v in batch.items()}
            g, metrics = value_and_grad(loss_fn, model, params, mb)
            history.append(metrics)
            if grads is None:
                grads = {n: x.float() for n, x in g.items()}
            else:
                for n, x in g.items():
                    grads[n].add_(x.float())
        count = torch.full((), microbatches, dtype=torch.float32)
        grads = {n: x / count.to(x.device) for n, x in grads.items()}
        metrics = {k: torch.stack([m[k] for m in history]).mean()
                   for k in history[0]}
        return grads, metrics

    def train_step(state: TrainState, batch: dict):
        zero1 = state.master is not None
        model = state.params
        params = trainable(model)
        if microbatches == 1:
            grads, metrics = value_and_grad(loss_fn, model, params, batch,
                                            cast=bf16)
        else:
            compute = (_compute_cast(params, torch.bfloat16)
                       if bf16 and not zero1 else params)
            grads, metrics = accumulated(model, compute, batch)
        if compressor is not None:
            grads = compressor(grads)
        master = state.master if zero1 else params
        # the gradients go to f32 leaf by leaf inside the update
        _, opt_state, gnorm = optimizer.update(grads, state.opt_state,
                                               master)
        del grads
        if zero1:                        # refresh the compute copy
            for name, p in params.items():
                if p is not master[name]:
                    p.copy_(master[name])
        state.opt_state = opt_state
        state.step = state.step + 1
        metrics["grad_norm"] = gnorm
        metrics["lr"] = optimizer._lr(opt_state.count)
        return state, metrics

    return train_step
