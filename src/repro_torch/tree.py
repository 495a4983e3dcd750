"""The port's tensors under the JAX package's parameter-tree paths.

A ``Model``'s buffer names are the JAX params tree's paths with the layer
index spliced in: the port's ``layers.3.attn.wq.w`` is layer 3 of the JAX
leaf ``layers|attn|wq|w``, stacked over the layers there; ``encoder.layers.
2...`` likewise, and the hybrid family's ``shared_attn`` is unstacked in
both.  A quantized weight's ``w_q_values`` / ``w_q_scale`` are the JAX
``QTensor``'s ``w_q|values`` / ``w_q|scale`` (an MoE expert stack's
``gate_values`` the JAX ``gate_q|values``).  ``jax_order`` sorts names as
``jax.tree.leaves`` visits their leaves (dict keys sorted at each level,
then the layer), so sums over leaves run in the JAX package's order;
``leaf_groups`` gathers each JAX leaf's layer tensors.
"""
from __future__ import annotations

from typing import Iterable

SEP = "|"


def jax_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """(the JAX tree path of a port buffer name, its layer or None)."""
    parts = name.split(".")
    path, layer = [], None
    for i, part in enumerate(parts):
        if part.isdigit() and i > 0 and parts[i - 1] == "layers":
            layer = int(part)
            continue
        for suffix in ("_values", "_scale"):
            if part.endswith(suffix) and i == len(parts) - 1:
                base = part[:-len(suffix)]
                path += [base if base == "w_q" else base + "_q",
                         suffix[1:]]
                break
        else:
            path.append(part)
    return tuple(path), layer


def jax_key(name: str) -> str:
    """The ``|``-joined JAX path of a port buffer name's leaf."""
    return SEP.join(jax_path(name)[0])


def _sort_key(name: str):
    path, layer = jax_path(name)
    return path, -1 if layer is None else layer


def jax_order(names: Iterable[str]) -> list[str]:
    """``names`` in the order ``jax.tree.leaves`` visits their leaves, each
    stacked leaf's layers in order."""
    return sorted(names, key=_sort_key)


def leaf_groups(names: Iterable[str]) -> list[tuple[str, list[str]]]:
    """(JAX key, the names of its layers in order) for each JAX leaf, in
    ``jax_order``."""
    groups: dict[str, list[str]] = {}
    for name in jax_order(names):
        groups.setdefault(jax_key(name), []).append(name)
    return list(groups.items())


def is_stacked(name: str) -> bool:
    """The JAX leaf stacks this name's layer with the others'."""
    return jax_path(name)[1] is not None
