"""PyTorch + CUDA port of the ``repro`` JAX/Pallas package, for NVIDIA Hopper.

The module tree mirrors ``repro`` so each function has one counterpart to
be checked against.  Entry points take an explicit ``device`` (default
``"cuda"``); kernel wrappers dispatch on the device of the tensor they are
given: a CPU tensor runs the plain PyTorch version, a CUDA tensor launches
the hand-written kernel in ``csrc/`` or raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
