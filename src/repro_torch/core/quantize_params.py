"""Model-wide offline weight quantization (serving path).

Walks a model's module tree and replaces every projection ``Linear`` holding
master weights with its per-output-channel int8 quantization — the paper's
static quantization of the Q/K/V (and here all projection) weights.  Norms,
embeddings, routers and the LM head stay in float.  The same key sets as
the JAX package's walk; they name the modules' attributes here.  The walk
takes any module: one decoder block at a time (``init_model``'s
``each_block``) quantizes a model that is never whole in f32.
"""
from __future__ import annotations

import copy

from torch import nn

from repro_torch.core.quantization import quantize
from repro_torch.core.quantized_linear import (Linear, quantize_linear,
                                               weight_channel_axes)
from repro_torch.models.moe import Experts

# attribute names whose Linear children are projection linears
_PROJ_KEYS = {
    "wq", "wk", "wv", "wo", "gate", "up", "down",
    "in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj",
}
# subtrees kept in float
_SKIP_KEYS = {"router", "conv_x", "conv_B", "conv_C", "ssm", "embed",
              "lm_head", "q_norm", "k_norm"}


def quantize_experts_stacks(experts: Experts) -> Experts:
    """The stacked (E, K, N) expert weights int8-quantized per (expert,
    output channel), their values left in the (E, K, N) layout."""
    return Experts(*(quantize(w, channel_axes=weight_channel_axes(w))
                     for w in (experts.gate, experts.up, experts.down)))


def quantize_model_params(model: nn.Module,
                          quantize_experts: bool = False, *,
                          in_place: bool = False) -> nn.Module:
    """Returns a new model with projection weights int8-quantized; the
    model it is given is left as it was, unless ``in_place`` (then it is
    quantized itself, one projection at a time, never held twice in f32:
    what a block drawn at full width wants).  ``quantize_experts``: also
    the MoE experts' stacked weights (the serving launcher's choice for
    the MoE family)."""
    if not in_place:
        model = copy.deepcopy(model)

    def walk(node: nn.Module) -> None:
        for k, v in list(node.named_children()):
            if k in _SKIP_KEYS or k.startswith("norm"):
                continue
            if (k in _PROJ_KEYS and isinstance(v, Linear)
                    and v.w is not None):
                setattr(node, k, quantize_linear(v))
            elif isinstance(v, Experts):
                if quantize_experts and v.gate is not None:
                    setattr(node, k, quantize_experts_stacks(v))
            else:
                walk(v)

    walk(model)
    return model
