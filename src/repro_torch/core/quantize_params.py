"""Model-wide offline weight quantization (serving path).

Walks a model's module tree and replaces every projection ``Linear`` holding
master weights with its per-output-channel int8 quantization — the paper's
static quantization of the Q/K/V (and here all projection) weights.  Norms,
embeddings and the LM head stay in float.  The same key sets as the JAX
package's walk; they name the modules' attributes here.
"""
from __future__ import annotations

import copy

from torch import nn

from repro_torch.core.quantized_linear import Linear, quantize_linear

# attribute names whose Linear children are projection linears
_PROJ_KEYS = {
    "wq", "wk", "wv", "wo", "gate", "up", "down",
    "in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj",
}
# subtrees kept in float
_SKIP_KEYS = {"router", "conv_x", "conv_B", "conv_C", "ssm", "embed",
              "lm_head", "q_norm", "k_norm"}


def quantize_model_params(model: nn.Module) -> nn.Module:
    """Returns a new model with projection weights int8-quantized; the
    model it is given is left as it was."""
    model = copy.deepcopy(model)

    def walk(node: nn.Module) -> None:
        for k, v in list(node.named_children()):
            if k in _SKIP_KEYS or k.startswith("norm"):
                continue
            if (k in _PROJ_KEYS and isinstance(v, Linear)
                    and v.w is not None):
                setattr(node, k, quantize_linear(v))
            else:
                walk(v)

    walk(model)
    return model
