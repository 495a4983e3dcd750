"""Checkpointing: save/restore keyed by the JAX package's tree paths, with
an async writer.

The on-disk layout is the JAX package's: ``step_XXXXXXXX/arrays.npz`` (one
array a pytree leaf, keyed by its ``|``-joined path) and ``meta.json``
(``step`` and the sorted keys), written to a ``.tmp`` directory and
renamed into place, so a crash mid-write never corrupts the latest
complete checkpoint; the ``keep`` newest are kept.  Keys are the JAX
tree's paths: a ``TrainState`` is written as the JAX package's
(``.params|…``, ``.opt_state|.mu|…``, ``.opt_state|.nu|…``,
``.opt_state|.count``, ``.step``, ``.master|…``), each per-layer tensor
stacked into its JAX leaf (``repro_torch.tree``), so a checkpoint written
by either package restores in the other.  A nested dict of tensors or
arrays is keyed by its sorted keys.

bf16 leaves, which numpy lacks, are written as f32 arrays of the same
values (exact), which the JAX package's restore casts back; a bf16 leaf the
JAX package wrote (numpy's raw 2-byte ``V2`` records of ml_dtypes'
bfloat16) is read back through its bit pattern.  ``restore_checkpoint``
writes the arrays into the tensors of ``like`` (a ``TrainState``: in place,
so a 43 GB state is never held twice) and returns it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import stack_named, to_numpy
from repro_torch.training.train_step import TrainState, trainable
from repro_torch.tree import SEP, is_stacked, leaf_groups

_SEP = SEP


def _state_dicts(state: TrainState) -> dict[str, dict]:
    """A TrainState's port-named tensor dicts under their JAX path
    prefixes."""
    out = {".params": trainable(state.params),
           ".opt_state|.mu": state.opt_state.mu,
           ".opt_state|.nu": state.opt_state.nu}
    if state.master is not None:
        out[".master"] = state.master
    return out


def _scalars(state: TrainState) -> dict[str, torch.Tensor]:
    return {".opt_state|.count": state.opt_state.count, ".step": state.step}


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """Every leaf as a host numpy array of its own, keyed by its JAX path."""
    if isinstance(tree, TrainState):
        flat = {}
        for prefix, named in _state_dicts(tree).items():
            flat.update({f"{prefix}{_SEP}{k}": v
                         for k, v in stack_named(named).items()})
        flat.update({k: to_numpy(v) for k, v in _scalars(tree).items()})
        return flat
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            sub = _flatten(tree[k])
            flat.update({(f"{k}{_SEP}{s}" if s else str(k)): v
                         for s, v in sub.items()})
        return flat
    if isinstance(tree, torch.Tensor):
        return {"": to_numpy(tree)}
    return {"": np.array(tree, copy=True)}


def save_checkpoint(directory: str, step: int, state: Any, *,
                    keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    return _write(directory, step, _flatten(state), keep)


def _write(directory: str, step: int, flat: dict, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": int(step), "keys": sorted(flat.keys())}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "meta.json"))]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device; a raw 2-byte
    record (the JAX package's bf16) by its bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if like.dtype != torch.bfloat16:
            raise TypeError(f"a bf16 array cannot restore a {like.dtype} "
                            "tensor")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())          # 0-d stays 0-d
    return t.to(device=like.device, dtype=like.dtype)


def _restore_into(arr: np.ndarray, like: torch.Tensor, key: str) -> None:
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                         f"{tuple(like.shape)}")
    like.copy_(_to_tensor(arr, like))


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: a TrainState's tensors are
    overwritten in place and the state returned; a nested dict comes back
    as a new dict of tensors of ``like``'s dtypes and devices."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        if isinstance(like, TrainState):
            for prefix, named in _state_dicts(like).items():
                for key, names in leaf_groups(named):
                    arr = data[f"{prefix}{_SEP}{key}"]
                    if not is_stacked(names[0]):
                        _restore_into(arr, named[names[0]], key)
                        continue
                    if arr.shape[0] != len(names):
                        raise ValueError(f"{prefix}{_SEP}{key}: "
                                         f"{arr.shape[0]} layers in the "
                                         f"checkpoint, {len(names)} here")
                    for i, name in enumerate(names):
                        _restore_into(arr[i], named[name], key)
            for key, t in _scalars(like).items():
                _restore_into(data[key], t, key)
            return like
        return _restore_tree(data, like, "")


def _restore_tree(data, like, prefix: str):
    if isinstance(like, dict):
        return {k: _restore_tree(data, v, f"{prefix}{_SEP}{k}" if prefix
                                 else str(k))
                for k, v in like.items()}
    arr = data[prefix]
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                         f"{tuple(like.shape)}")
    return _to_tensor(arr, like)


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training (single writer)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        # materialize on the host before handing to the writer thread
        flat = _flatten(state)

        def _write_it():
            _write(self.directory, step, flat, self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=_write_it, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
