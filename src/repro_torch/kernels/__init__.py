"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper (``<kernel>/ops.py``) dispatches on the device of its input:
CPU tensors run ``<kernel>/ref.py``; CUDA tensors launch the CUDA kernel
from ``csrc/`` and add one to the wrapper's ``launches`` count (K4's verify
mode to ``verify_launches``; K1's absmax mode counts in ``row_absmax``, its
given-absmax mode with its own wrapper's, and K2's int32-out and epilogue
modes in ``tiled_matmul_int32`` and ``int8_epilogue``).  The wrappers that pick a variant before
launch (K1 by row mapping, K2 and K3 by GEMM variant) also count each
launch in their ``plans`` counter under the variant's name; K2 and K3
count them by whole plan (``GemmPlan``) in ``launched_plans`` too.  K5
(``flash_attention``) is differentiable on CUDA through its backward
kernels, whose calls count in ``backward_launches``; the other kernels
have no backward, and their wrappers raise (``no_backward``) where autograd
would need one rather than hand back a detached output.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Autograd would differentiate through an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def no_backward(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through ``kernel``'s
    output: its launch writes through a raw pointer, so the output would
    reach the loss detached and the gradient would be lost without a
    word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            "requires grad; run it under torch.no_grad(), or train with "
            "quant_proj='none' (the only mode the port trains on the card)")


def _counters():
    """Each count's name → (wrapper, attribute holding the count)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, paged_decode_attention)
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.quant_act.ops import (quant_act, quant_act_glu,
                                                   row_absmax)
    from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                      tiled_matmul,
                                                      tiled_matmul_int32)
    return {"quant_act": (quant_act, "launches"),
            "quant_act_glu": (quant_act_glu, "launches"),
            "row_absmax": (row_absmax, "launches"),
            "tiled_matmul_int32": (tiled_matmul_int32, "launches"),
            "int8_epilogue": (int8_epilogue, "launches"),
            "fused_qkv": (fused_qkv, "launches"),
            "tiled_matmul": (tiled_matmul, "launches"),
            "paged_decode": (paged_decode_attention, "launches"),
            "paged_decode_verify": (paged_decode_attention,
                                    "verify_launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_backward": (flash_attention,
                                         "backward_launches")}


def _planned():
    """Each planning wrapper's name → the wrapper (its ``plans`` Counter)."""
    counters = _counters()
    return {name: counters[name][0] for name in
            ("quant_act", "quant_act_glu", "tiled_matmul", "fused_qkv")}


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset; K4's
    plain and verify launches count apart (``paged_decode`` and
    ``paged_decode_verify``)."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def plan_counts() -> dict[str, dict[str, int]]:
    """Launches since the last reset of each planning wrapper, by variant;
    each sums to its ``launch_counts`` entry."""
    return {name: dict(fn.plans) for name, fn in _planned().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    for fn in _planned().values():
        fn.plans.clear()
        if hasattr(fn, "launched_plans"):
            fn.launched_plans.clear()
