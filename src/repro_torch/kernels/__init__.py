"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper (``<kernel>/ops.py``) dispatches on the device of its input:
CPU tensors run ``<kernel>/ref.py``; CUDA tensors launch the CUDA kernel
from ``csrc/`` and add one to the wrapper's ``launches`` count.
"""
from __future__ import annotations


def _wrappers():
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, paged_decode_attention)
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.quant_act.ops import quant_act
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    return {"quant_act": quant_act, "fused_qkv": fused_qkv,
            "tiled_matmul": tiled_matmul,
            "paged_decode": paged_decode_attention,
            "flash_attention": flash_attention}


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
