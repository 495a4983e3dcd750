"""Carry weights across from the JAX package.

``params_from_numpy`` takes a JAX params pytree already converted to a
nested dict of numpy arrays — each ``QTensor`` given as ``{"values",
"scale", "bits"}`` — and builds the port's ``Model`` from it, splitting the
layer-stacked ``(L, …)`` leaves into per-layer modules.  Values are copied
exactly, so the port and the JAX package run the same weights; quantized
projection values are stored K-major, the layout the int8 GEMM kernels
read.  An MoE layer's router, expert stacks (float ``gate``/``up``/``down``
or quantized ``gate_q``/``up_q``/``down_q``, kept in their (E, K, N)
layout: no kernel reads them) and shared FFN are carried the same way,
as are an SSM layer's norm and Mamba2 block (five in-projections,
``out_proj``, the three conv taps, ``A_log`` / ``D`` / ``dt_bias`` and the
gated norm) and the hybrid family's unstacked ``shared_attn`` block.  An
encoder-decoder's decoder blocks carry their ``norm_cross`` and ``cross``
attention, and its ``encoder`` stack and final norm come across as the
decoder's layers do.

``params_to_numpy`` is the inverse: a ``Model``'s buffers as the JAX
package's nested tree of numpy arrays, the per-layer tensors stacked again
(``repro_torch.tree`` maps the names).

``shard_model`` slices a whole model (converted, or initialised by the
port) into one rank's shard of a serving mesh by the placements of
``launch/sharding.py``, so that both packages can be held on the same
weights at every mesh size.  ``shard_train_state`` does the same for a
train state over a ``("data", "model")`` mesh: the compute copy by the
compute rules, the f32 master and AdamW moments by the FSDP rules, as the
JAX package's dry run places a train cell (``launch/dryrun.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch import tree as _tree
from repro_torch.core.quantization import QTensor, k_major
from repro_torch.core.quantized_linear import Linear
from repro_torch.models.attention import Attention
from repro_torch.models.config import ModelConfig
from repro_torch.launch.sharding import (make_param_rules,
                                         model_param_shapes, on_axis,
                                         param_specs, train_placement)
from repro_torch.models.ffn import FFN
from repro_torch.models.layers import Embedding, LMHead, Norm
from repro_torch.models.moe import Experts, MoE
from repro_torch.models.ssm import (IN_PROJ, ConvWeight, Mamba2, SSMParams,
                                   check_head_split)
from repro_torch.models.transformer import (DecoderBlock, Encoder, Model,
                                            SSMBlock, check_supported,
                                            is_ssm_family)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _norm(node, i=None) -> Norm | None:
    if node is None:
        return None
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    b = node.get("b")
    return Norm(_t(pick(node["w"])), None if b is None else _t(pick(b)))


def _linear(node, i) -> Linear | None:
    if node is None:
        return None
    b = _t(node["b"][i]) if "b" in node else None
    if "w_q" in node:
        q = node["w_q"]
        return Linear(w_q=QTensor(k_major(_t(q["values"][i])),
                                  _t(q["scale"][i]), int(q.get("bits", 8))),
                      b=b)
    return Linear(w=_t(node["w"][i]), b=b)


def _ffn(f, i) -> FFN | None:
    if f is None:
        return None
    return FFN(_linear(f["up"], i), _linear(f["down"], i),
               _linear(f.get("gate"), i))


def _expert_stack(experts: dict, name: str, i: int):
    if name in experts:
        return _t(experts[name][i])
    q = experts[name + "_q"]
    return QTensor(_t(q["values"][i]), _t(q["scale"][i]),
                   int(q.get("bits", 8)))


def _moe(m, i) -> MoE | None:
    if m is None:
        return None
    experts = Experts(*(_expert_stack(m["experts"], name, i)
                        for name in Experts.NAMES))
    return MoE(_linear(m["router"], i), experts, _ffn(m.get("shared"), i))


def _attention(a, i) -> Attention | None:
    if a is None:
        return None
    return Attention(_linear(a["wq"], i), _linear(a["wk"], i),
                     _linear(a["wv"], i), _linear(a["wo"], i),
                     _norm(a.get("q_norm"), i), _norm(a.get("k_norm"), i))


def _block(layers: dict, i: int) -> DecoderBlock:
    return DecoderBlock(_norm(layers["norm_attn"], i),
                        _attention(layers["attn"], i),
                        _norm(layers["norm_ffn"], i),
                        _ffn(layers.get("ffn"), i),
                        _norm(layers.get("norm_attn_post"), i),
                        _norm(layers.get("norm_ffn_post"), i),
                        moe=_moe(layers.get("moe"), i),
                        norm_cross=_norm(layers.get("norm_cross"), i),
                        cross=_attention(layers.get("cross"), i))


def _ssm_block(layers: dict, i: int) -> SSMBlock:
    m = layers["mamba"]
    s = m["ssm"]
    mamba = Mamba2(*(_linear(m[name], i) for name in IN_PROJ),
                   *(ConvWeight(_t(m[name]["w"][i]))
                     for name in ("conv_x", "conv_B", "conv_C")),
                   SSMParams(_t(s["A_log"][i]), _t(s["D"][i]),
                             _t(s["dt_bias"][i])),
                   _norm(m["norm"], i), _linear(m["out_proj"], i))
    return SSMBlock(_norm(layers["norm"], i), mamba)


def _with_layer_axis(node):
    """An unstacked subtree (the shared block) as a stack of one."""
    if isinstance(node, dict):
        return {k: _with_layer_axis(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return node[None]
    return node                           # a QTensor's ``bits``


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """The port's ``Model`` holding the weights of a numpy params tree."""
    check_supported(cfg)
    dev = resolve_device(device)
    head = tree.get("lm_head")
    block = _ssm_block if is_ssm_family(cfg) else _block
    shared = tree.get("shared_attn")
    enc = tree.get("encoder")
    encoder = None if enc is None else Encoder(
        [_block(enc["layers"], i) for i in range(cfg.n_encoder_layers)],
        _norm(enc["final_norm"]))
    model = Model(Embedding(_t(tree["embed"]["table"])),
                  _norm(tree["final_norm"]),
                  [block(tree["layers"], i) for i in range(cfg.n_layers)],
                  LMHead(_t(head["w"])) if head is not None else None,
                  None if shared is None
                  else _block(_with_layer_axis(shared), 0), encoder)
    return model.to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of its own (bf16, which numpy
    lacks, as the f32 array of the same values)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def stack_named(named: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port-named tensors as {JAX key: numpy array}, each stacked leaf's
    layers stacked on a new first axis (``to_numpy`` values)."""
    out = {}
    for key, names in _tree.leaf_groups(named):
        arrays = [to_numpy(named[n]) for n in names]
        out[key] = (np.stack(arrays) if _tree.is_stacked(names[0])
                    else arrays[0])
    return out


def params_to_numpy(model: Model, cfg: ModelConfig) -> dict:
    """The JAX package's nested params tree of ``model``'s weights as
    numpy arrays (bf16 as f32, exactly), each QTensor as ``{"values",
    "scale", "bits"}``: what ``params_from_numpy`` takes."""
    check_supported(cfg)
    tree: dict = {}

    def put(path, value):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    for key, arr in stack_named(dict(model.named_buffers())).items():
        put(key.split(_tree.SEP), arr)
    for name, mod in model.named_modules():
        quantized = []
        if isinstance(mod, Linear) and mod.w_q_values is not None:
            quantized = ["w_q_values"]
        elif isinstance(mod, Experts):
            quantized = [f"{w}_values" for w in Experts.NAMES
                         if getattr(mod, f"{w}_values") is not None]
        for buf in quantized:
            path = _tree.jax_path(f"{name}.{buf}" if name else buf)[0]
            put(path[:-1] + ("bits",), mod.bits)
    return tree


def shard_train_state(model: Model, optimizer, mesh, *, zero1: bool):
    """A ``TrainState`` of the whole f32 ``model``, sliced into this rank's
    share of ``mesh`` (a ``launch.mesh.Mesh``, ``("data", "model")`` or
    ``("model",)``): the placements come from the whole shapes
    (``launch.sharding.train_placement``), ``shard_model`` keeps the
    rank's compute slices, and ``TrainState.create`` takes the master's
    FSDP slices of them (ZeRO-1) or keeps them as the parameters (f32)."""
    from repro_torch.training.train_step import TrainState
    placement = train_placement(model_param_shapes(model), mesh)
    shard_model(model, mesh)
    return TrainState.create(model, optimizer, zero1=zero1,
                             placement=placement)


def shard_model(model: nn.Module, mesh):
    """Slice ``model`` in place into this rank's shard of ``mesh`` (a
    ``launch.mesh.Mesh``) and return it.

    Each weight is placed by ``launch.sharding.param_specs`` under the
    serving rules (``make_param_rules()``): a dim placed on ``model``
    keeps this rank's equal, contiguous slice, and the rest is freed.  A ``Linear`` whose output
    columns are split becomes ``shard = "column"``, one whose input rows
    (K) are split ``"row"``; an ``Embedding`` or ``LMHead`` split by
    vocabulary ``"vocab"``; each gets the mesh.  Quantized values stay
    K-major, and a weight is quantized whole before it is sliced (its
    per-column scales are the whole column's).  An MoE layer's ``Experts``
    keep the rank's slice of the expert dim, or else of ``expert_mlp``
    (int8 values with their (E, 1, N) scales alike; the router stays
    replicated, as in the JAX package's serving rules), and its ``MoE``
    gets the mesh (``models/moe.py`` reads the split from the slice's
    shape).  A Mamba2 block keeps its ``in_z`` / ``in_x`` columns and
    ``out_proj`` rows (``"column"`` / ``"row"``) and its ``conv_x``
    channels of the rank's SSM heads, its other weights whole, and gets
    the mesh (``models/ssm.py``); SSM heads that do not divide the mesh
    raise.  A hybrid's shared block is sliced as a dense decoder block, and
    an encoder-decoder's ``Encoder`` layers and its decoder blocks'
    ``cross`` projections by the same path rules (a vocabulary that does
    not divide the mesh, seamless's 256,206 on 4, leaves the embedding and
    head whole: shard-if-divisible).  ``model.mesh`` is set, so
    the forward runs the rank's program.  ``model`` may be a whole
    ``Model`` or one block (``init_model(each_block=...)`` shards each
    block as it is drawn); modules sliced before are left as they are.  A
    mesh of one rank slices nothing."""
    model.mesh = mesh
    for mod in model.modules():
        if isinstance(mod, (Attention, MoE, Mamba2)):
            mod.mesh = mesh
        if isinstance(mod, Mamba2):
            check_head_split(mod.ssm.A_log.shape[0], mesh.size)
    if mesh.size == 1:
        return model
    specs = param_specs(model_param_shapes(model), mesh, make_param_rules())
    before = {id(m) for m in model.modules() if getattr(m, "_sliced", False)}
    for name, spec in specs.items():
        dims = [d for d, entry in enumerate(spec) if on_axis(entry)]
        if not dims:
            continue
        if len(dims) > 1:
            raise ValueError(f"{name}: placed on 'model' twice ({spec})")
        owner_name, attr = name.rpartition(".")[::2]
        owner = model.get_submodule(owner_name)
        if id(owner) in before:
            continue
        t = getattr(owner, attr)
        lo, hi = mesh.shard_bounds(t.shape[dims[0]])
        part = t.narrow(dims[0], lo, hi - lo)
        # a copy of its own, so the whole tensor's memory is freed
        part = (k_major(part) if attr == "w_q_values"
                else part.clone(memory_format=torch.contiguous_format))
        setattr(owner, attr, part)
        if isinstance(owner, Linear):
            kind = "column" if dims[0] == t.dim() - 1 else "row"
            if attr in ("w", "w_q_values"):
                owner.shard = kind
        elif isinstance(owner, (Embedding, LMHead)):
            owner.shard = "vocab"
        owner.mesh = mesh
        owner._sliced = True
    return model
