"""Logical-axis sharding rules and the placement of each parameter.

The JAX package's rule resolution, ported as it is: activations and
parameters carry *logical* axis names, and rules map each name to mesh
axes.  Where the JAX package hands the result to GSPMD as a
``PartitionSpec``, the port returns the same entries as a plain tuple (one
entry per dimension: ``None``, an axis name, or a tuple of axis names) and
``bridge.shard_model`` slices each tensor by it.

Policies (``docs/DESIGN.md`` §3):
  * shard-if-divisible — a dim that does not divide the mesh-axis extent is
    replicated, not padded.
  * candidate chains — a logical axis lists mesh-axis candidates in order
    of preference; the first whose extent divides the dim and whose axes
    no other dim of the same array has taken wins.
  * FSDP — training rules (``fsdp=True``) also shard the ``embed`` and
    ``experts`` parameter dims over ``data``; the ``dp`` profile gives the
    batch every axis.  Sharded training (``training/train_step.py``) keeps
    its bf16 compute copy by the compute rules (``fsdp=False``) and the
    f32 master and AdamW moments by the FSDP rules (ZeRO-1):
    ``TrainPlacement`` holds both (an MoE layer's expert stacks move
    between them through the whole tensor, ``relayout``), and
    ``shard_like_params`` takes a rank's FSDP slice of its compute-layout
    tensors (the JAX package's
    ``shard_like_params`` constrains a tree to those placements).
    ``shard_batch`` places the batch by the activation rules, over
    ``data``.

A mesh here is anything with a ``shape`` mapping axis names to extents
(``launch.mesh.Mesh``, or a stand-in in the tests).  The port's parameter
names map to the JAX tree's paths through ``repro_torch.tree``: a layer's
tensor gets the placement of its stacked JAX leaf without the layer axis.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

from repro_torch import tree as _tree

__all__ = ["DEFAULT_LOGICAL_RULES", "PARAM_RULES", "make_activation_rules",
           "make_param_rules", "spec_for", "logical_axes_for_path",
           "param_specs", "tree_specs", "model_param_shapes", "on_axis",
           "entry_axes", "local_shape", "take_shard", "TrainPlacement",
           "train_placement", "shard_like_params", "shard_batch",
           "BATCH_AXES", "gather_whole", "RELAYOUT"]

# --------------------------------------------------------------------------
# Activation rules
# --------------------------------------------------------------------------
DEFAULT_LOGICAL_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), "data"),
    "seq": (("pod", "data"), "data"),
    "kv_seq": (("pod", "data", "model"), ("data", "model"), "model"),
    # the paged pool's page dim takes the split-KV role of kv_seq
    "kv_pages": (("pod", "data", "model"), ("data", "model"), "model"),
    "vocab": ("model",),
    "embed": (None,),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (None,),
    "table_embed": (None,),
    # the residual stream's seq dim between blocks (sequence parallelism)
    "act_seq": ("model",),
}

# --------------------------------------------------------------------------
# Param rules (path pattern -> logical axes, right-aligned; first match
# wins).  A quantized weight's ``w_q/values`` and ``w_q/scale`` take the
# same axes (a size-1 scale dim never divides an extent: replicated).
# --------------------------------------------------------------------------
PARAM_RULES: list[tuple[str, tuple]] = [
    # tables use an embed-dim axis of their own that FSDP must not move
    (r"embed/table", ("vocab", "table_embed")),
    (r"lm_head/w", ("vocab", "table_embed")),
    (r"wq/(w|w_q/values|w_q/scale)$", ("embed", "heads")),
    (r"(wk|wv)/(w|w_q/values|w_q/scale)$", ("embed", "kv_heads")),
    (r"wq/b$", ("heads",)),
    (r"(wk|wv)/b$", ("kv_heads",)),
    (r"wo/(w|w_q/values|w_q/scale)$", ("heads", "embed")),
    (r"(gate|up)/(w|w_q/values|w_q/scale)$", ("embed", "mlp")),
    (r"down/(w|w_q/values|w_q/scale)$", ("mlp", "embed")),
    (r"router/w", ("embed", None)),
    (r"experts/(gate|up)", ("experts", "embed", "expert_mlp")),
    (r"experts/down", ("experts", "expert_mlp", "embed")),
    (r"in_(z|x)/(w|w_q/values|w_q/scale)$", ("embed", "ssm_inner")),
    (r"in_(B|C|dt)/(w|w_q/values|w_q/scale)$", ("embed", None)),
    (r"out_proj/(w|w_q/values|w_q/scale)$", ("ssm_inner", "embed")),
    (r"conv_x/w", (None, "ssm_inner")),
    (r"conv_(B|C)/w", (None, None)),
    (r"ssm/(A_log|D|dt_bias)", (None,)),
    (r"norm", (None,)),
    (r"(q_norm|k_norm)", (None,)),
    (r"/b$", (None,)),
]


def make_activation_rules(profile: str = "tp") -> dict:
    """Activation rules per parallelism profile: ``tp`` puts the batch on
    the data axes and tensor-parallel dims on ``model``; ``dp`` lets the
    batch claim every axis it divides (the TP rules then find ``model``
    taken)."""
    rules = dict(DEFAULT_LOGICAL_RULES)
    if profile == "dp":
        rules["batch"] = (("pod", "data", "model"), ("data", "model"),
                          ("pod", "data"), "data")
        rules["seq"] = rules["batch"]
    return rules


def make_param_rules(fsdp: bool = False, profile: str = "tp") -> dict:
    """Logical → mesh rules for parameters (distinct from activations)."""
    rules = dict(DEFAULT_LOGICAL_RULES)
    if profile == "dp":
        # no tensor parallelism; FSDP shards storage over both axes
        for k in ("heads", "kv_heads", "mlp", "experts", "expert_mlp",
                  "ssm_heads", "ssm_inner", "vocab"):
            rules[k] = (None,)
        if fsdp:
            rules["embed"] = (("data", "model"), "data")
            rules["mlp"] = (("data", "model"), "data")
            rules["expert_mlp"] = (("data", "model"), "data")
        return rules
    if fsdp:
        rules["embed"] = ("data",)          # ZeRO-3 storage shard
        rules["experts"] = ("data",)        # expert-dim storage shard
    return rules


def _extent(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def _mesh_axes_for(logical: str | None, dim: int, mesh, rules: dict,
                   used: set) -> Any:
    if logical is None:
        return None
    for candidate in rules.get(logical, (None,)):
        if candidate is None:
            return None
        axes = candidate if isinstance(candidate, tuple) else (candidate,)
        if not all(a in mesh.shape for a in axes):
            continue
        if any(a in used for a in axes):
            continue
        if dim % _extent(mesh, axes) == 0:
            return candidate
    return None


def spec_for(shape: tuple, logical_axes: tuple, mesh,
             rules: dict | None = None) -> tuple:
    """The placement of an array of ``shape`` whose dims carry
    ``logical_axes``: one entry per dim."""
    rules = rules or DEFAULT_LOGICAL_RULES
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} vs logical axes "
                         f"{tuple(logical_axes)}")
    used: set = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        res = _mesh_axes_for(name, dim, mesh, rules, used)
        if res is not None:
            used.update(res if isinstance(res, tuple) else (res,))
        out.append(res)
    return tuple(out)


def logical_axes_for_path(path_str: str, ndim: int) -> tuple:
    """The logical axes of the parameter at ``path_str`` (``/``-joined
    JAX path) with ``ndim`` dims: the first matching rule, right-aligned."""
    for pattern, axes in PARAM_RULES:
        if re.search(pattern, path_str):
            if len(axes) < ndim:      # left-pad (layer-stacked leading dims)
                axes = (None,) * (ndim - len(axes)) + tuple(axes)
            elif len(axes) > ndim:
                axes = tuple(axes[-ndim:]) if ndim else ()
            return tuple(axes)
    return (None,) * ndim


def _jax_leaf(name: str, shape: tuple) -> tuple[str, tuple, bool]:
    """(``/``-joined JAX path, the JAX leaf's shape, stacked?) of a port
    tensor name: a stacked leaf has the layer axis in front."""
    path, layer = _tree.jax_path(name)
    stacked = layer is not None
    return "/".join(path), ((0,) if stacked else ()) + tuple(shape), stacked


def param_specs(shapes: dict[str, tuple], mesh,
                rules: dict | None = None) -> dict[str, tuple]:
    """The placement of each parameter: ``shapes`` maps the port's tensor
    names (``model_param_shapes``) to their shapes.  A layer's tensor gets
    its stacked JAX leaf's placement without the layer axis (the rules
    never shard that axis)."""
    rules = rules or make_param_rules()
    out = {}
    for name, shape in shapes.items():
        path, jshape, stacked = _jax_leaf(name, shape)
        axes = logical_axes_for_path(path, len(jshape))
        spec = spec_for(jshape, axes, mesh, rules)
        out[name] = spec[1:] if stacked else spec
    return out


def tree_specs(shapes: dict[str, tuple], logical_axes: dict, mesh,
               rules: dict | None = None) -> dict[str, tuple]:
    """Placements of an ad-hoc tree (the cache) from explicit logical
    axes: ``shapes`` and ``logical_axes`` map the same keys."""
    rules = rules or DEFAULT_LOGICAL_RULES
    return {k: spec_for(tuple(shapes[k]), tuple(logical_axes[k]), mesh,
                        rules) for k in shapes}


def on_axis(entry, axis: str = "model") -> bool:
    """Whether one dim's placement (None, an axis, or a tuple of axes)
    includes mesh axis ``axis``."""
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def model_param_shapes(model) -> dict[str, tuple]:
    """{tensor name: shape} of a ``Model``'s weights (its buffers)."""
    return {name: tuple(t.shape) for name, t in model.named_buffers()}


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one dim's placement entry (None: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """One rank's block of an array of ``shape`` placed by ``spec``."""
    out = []
    for n, entry in zip(shape, spec):
        ext = _extent(mesh, entry_axes(entry))
        if n % ext:
            raise ValueError(f"{tuple(shape)} by {spec}: {n} does not split "
                             f"over {ext}")
        out.append(n // ext)
    return tuple(out)


def take_shard(t, spec: tuple, mesh):
    """This rank's block of the whole tensor ``t`` placed by ``spec`` (a
    view; ``mesh`` a ``launch.mesh.Mesh``)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            n = t.shape[dim] // mesh.extent(axes)
            t = t.narrow(dim, mesh.index(axes) * n, n)
    return t


@dataclasses.dataclass
class TrainPlacement:
    """Where a sharded train state lives, by the port's tensor names.

    ``compute`` places each compute-copy tensor (the model's buffers) by
    the compute rules, ``fsdp`` each master, moment and reduced gradient
    tensor by the FSDP rules: whole-tensor entries, as ``param_specs``
    gives them.  ``fsdp_dim`` is, for each name, the dim of the rank's
    compute slice that the FSDP rules split further, and the axes they
    split it over (None where the two placements agree, or where the FSDP
    slice is not inside the compute slice).  ``relayout`` names the
    tensors of that last kind: an MoE layer's expert stacks, which compute
    E-split over ``model`` but rest split over ``data`` by expert and over
    ``model`` by ``expert_mlp`` (the JAX package's FSDP rules).  Their way
    between the layouts goes through the whole tensor (``gather_whole``):
    the master's slice is taken from it, a gradient is gathered whole over
    ``model``, sliced by the FSDP placement and reduce-scattered over
    ``data``, and the compute copy is the master gathered whole over both
    axes, then sliced; the state a rank keeps is only its slices, the
    bytes the dry run predicts.  ``partial`` names the tensors replicated
    over ``model`` whose gradients are each rank's share: a
    tensor-parallel attention's unsplit K/V projections (KV heads that do
    not divide ``model``) and its q/k norms, which feed only the rank's
    heads, and a tensor-parallel Mamba2 block's ``in_B``, ``in_C``,
    ``in_dt``, ``conv_B``, ``conv_C``, ``A_log``, ``D``, ``dt_bias`` and
    gated-norm weight, whose outputs (or slices) feed only the rank's SSM
    heads or channels."""
    mesh: Any
    compute: dict
    fsdp: dict
    fsdp_dim: dict
    partial: frozenset
    relayout: frozenset = frozenset()

    def grad_specs(self, zero1: bool) -> dict:
        """The placement of each reduced gradient: the FSDP slices under
        ZeRO-1, the compute slices in the classic layout."""
        return self.fsdp if zero1 else self.compute


# _refinement's answer for an FSDP slice that is not inside the compute
# slice
RELAYOUT = "relayout"


def _refinement(c, f):
    """(dim, axes) where ``f`` splits one dim ``c`` leaves whole, None where
    the two agree, ``RELAYOUT`` otherwise."""
    out = None
    for dim, (ce, fe) in enumerate(zip(c, f)):
        ca, fa = entry_axes(ce), entry_axes(fe)
        if ca == fa:
            continue
        if ca or out is not None:
            return RELAYOUT
        out = (dim, fa)
    return out


def train_placement(shapes: dict[str, tuple], mesh) -> TrainPlacement:
    """The ZeRO-1 placement of a model of whole ``shapes`` on ``mesh`` by
    the ``tp`` profile the JAX package's launcher trains with: the
    compute copy by ``make_param_rules(fsdp=False)``, the master and
    moments by ``make_param_rules(fsdp=True)``, as its dry run places a
    train cell."""
    compute = param_specs(shapes, mesh, make_param_rules(False))
    fsdp = param_specs(shapes, mesh, make_param_rules(True))
    cuts = {n: _refinement(compute[n], fsdp[n]) for n in shapes}
    relayout = frozenset(n for n, cut in cuts.items() if cut == RELAYOUT)
    fsdp_dim = {n: None if n in relayout else cut for n, cut in cuts.items()}
    partial = set()
    for name, spec in compute.items():
        if any(on_axis(e) for e in spec):
            continue
        # a tensor-parallel attention's whole tensors but wo's; a
        # tensor-parallel Mamba2 block's whole tensors (models/ssm.py)
        for block, split in ((".attn.", "wq.w"), (".mamba.", "in_x.w")):
            head, sep, rest = name.partition(block)
            if sep and not rest.startswith("wo.") and any(
                    on_axis(e)
                    for e in compute.get(f"{head}{block}{split}", ())):
                partial.add(name)
    return TrainPlacement(mesh, compute, fsdp, fsdp_dim, frozenset(partial),
                          relayout)


def gather_whole(t, spec: tuple, mesh):
    """The whole tensor from each rank's block ``t`` placed by ``spec``:
    all-gathered over each split dim's axes (``mesh`` a
    ``launch.mesh.Mesh``; every rank of those axes calls it)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            t = mesh.all_gather(t, dim=dim, axis=axes)
    return t


def shard_like_params(tree: dict, placement: TrainPlacement) -> dict:
    """Each rank's FSDP slice of its compute-layout tensors ``tree``
    (gradients, weights), by name: a view where the slice lies inside the
    compute slice, else taken from the whole tensor (``relayout``: a
    collective, so every rank calls it with the same names).  The
    counterpart of the JAX package's ``shard_like_params``."""
    mesh = placement.mesh
    out = {}
    for name, t in tree.items():
        if name in placement.relayout:
            t = take_shard(gather_whole(t, placement.compute[name], mesh),
                           placement.fsdp[name], mesh)
        cut = placement.fsdp_dim[name]
        if cut is not None:
            dim, axes = cut
            n = t.shape[dim] // mesh.extent(axes)
            t = t.narrow(dim, mesh.index(axes) * n, n)
        out[name] = t
    return out


# the logical axes of a training batch's arrays
BATCH_AXES = {"inputs": ("batch", None), "targets": ("batch", None),
              "frontend_embeds": ("batch", None, None),
              "encoder_frames": ("batch", None, None),
              "memory": ("batch", None, None),
              "tokens": ("batch", None)}


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch, placed by the ``tp`` activation
    rules: its rows over ``data`` where they divide it."""
    specs = tree_specs({k: tuple(v.shape) for k, v in batch.items()},
                       {k: BATCH_AXES[k] for k in batch}, mesh,
                       make_activation_rules("tp"))
    return {k: take_shard(v, specs[k], mesh) for k, v in batch.items()}
