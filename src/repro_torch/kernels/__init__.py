"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper (``<kernel>/ops.py``) dispatches on the device of its input:
CPU tensors run ``<kernel>/ref.py``; CUDA tensors launch the CUDA kernel
from ``csrc/`` and add one to the wrapper's ``launches`` count (K4's verify
mode to ``verify_launches``).
"""
from __future__ import annotations


def _counters():
    """Each count's name → (wrapper, attribute holding the count)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, paged_decode_attention)
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.quant_act.ops import quant_act
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    return {"quant_act": (quant_act, "launches"),
            "fused_qkv": (fused_qkv, "launches"),
            "tiled_matmul": (tiled_matmul, "launches"),
            "paged_decode": (paged_decode_attention, "launches"),
            "paged_decode_verify": (paged_decode_attention,
                                    "verify_launches"),
            "flash_attention": (flash_attention, "launches")}


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset; K4's
    plain and verify launches count apart (``paged_decode`` and
    ``paged_decode_verify``)."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
