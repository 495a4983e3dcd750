"""Wrapper for the tiled int8 GEMM: CUDA kernel K2 on the card, the plain
version on the CPU.

The kernel reads the weights K-major: ``b.values`` is the (K, N) view of an
(N, K)-contiguous tensor, as ``quantize_weight`` stores them at rest (wgmma
reads 8-bit operands only K-major, and TMA cannot transpose bytes).  A
row-major B on the card raises; it is never transposed here.

The plan (``GemmPlan``: variant, wgmma width, K split) is picked before
launch by the dispatcher, ``core/dispatch.py``: a measured plan from its
table where it has one for the shapes, else ``gemm_plan``'s analytic pick
from the shapes and the operands' alignment (see ``csrc/int8_gemm.cu``):

* ``wide``: large M (prefill), tensor cores on 128 x 256 output tiles;
* ``swap``: small M (decode, verify, short prefills), tensor cores with
  the weights on wgmma's 64-row side and the activation rows on its N
  side, padded to 8/16/32/64 (tiles of 64 rows past 64), K split over
  blocks where the tiles leave SMs idle (int32 partials, summed by a
  second kernel);
* ``general``: what TMA cannot describe (K not a multiple of 16, a base not
  16-byte aligned): ``__dp4a`` on 64 x 64 tiles.

``check_plan`` holds the plan to the shapes before launch, and the C
launcher checks it again against its own tile geometry: a plan that does
not cover K's k-steps exactly once, or a width the variant is not built
for, raises rather than returning a partial product.

Two more modes serve the row-parallel projections of a serving mesh
(``core/quantized_linear.py``), where each rank holds a slice of K:
``tiled_matmul_int32`` is K2 without its epilogue (the exact int32
product, by the swap variant, whose scratch is its output), and
``int8_epilogue`` is K2's epilogue alone on an int32 product (the ranks'
sum), as every variant computes it: bitwise the unsplit K2.
"""
from __future__ import annotations

import collections
from typing import Sequence

import torch

from repro_torch.core import dispatch
from repro_torch.core.quantization import QTensor
from repro_torch.core.tiling import (BK, MAX_K, SWAP_COLS, TMA_ALIGN,
                                     VARIANTS, WIDE_COLS, GemmPlan,
                                     ceil_div, choose_plan, swap_plan)
from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.tiled_matmul import ref as _ref

__all__ = ["tiled_matmul", "tiled_matmul_int32", "int8_epilogue",
           "gemm_plan", "check_plan", "GemmPlan", "OUT_DTYPES"]

OUT_DTYPES = (torch.float32, torch.bfloat16)


def gemm_plan(m: int, ns: Sequence[int], k: int, aligned: bool) -> GemmPlan:
    """The analytic variant for A (m, k) times products of widths ``ns``
    (one for K2; Nq, Nkv, Nkv for K3), from the shapes and whether every
    operand's base is 16-byte aligned: ``core.tiling.choose_plan``.  The
    dispatcher (``core/dispatch.py``) starts from it, and returns it under
    ``REPRO_TUNE=off`` and where its table has no entry; tests and tools
    force a plan by patching this name (under ``REPRO_TUNE=off``)."""
    return choose_plan(m, tuple(ns), k, aligned)


def check_plan(plan: GemmPlan, m: int, ns: Sequence[int], k: int,
               aligned: bool) -> None:
    """Raise unless the kernel takes ``plan`` at these shapes: the general
    tile unsplit; a tensor-core variant only where TMA reads the operands
    (K a multiple of 16, aligned bases), at a width it is built for, its
    splits of ``chunk`` k-steps covering K's k-steps exactly once (the
    last split not empty), the wide one unsplit."""
    if plan.variant == "general":
        ok = plan.split == 1
    else:
        nk = ceil_div(k, BK)
        ok = (aligned and k % TMA_ALIGN == 0 and plan.chunk >= 1
              and (plan.split - 1) * plan.chunk < nk <= plan.split * plan.chunk
              and (plan.cols == WIDE_COLS and plan.split == 1
                   if plan.variant == "wide"
                   else plan.variant == "swap" and plan.cols in SWAP_COLS))
    if not ok:
        raise ValueError(f"{plan} does not fit A ({m}, {k}) times widths "
                         f"{list(ns)}{'' if aligned else ' (unaligned)'}")


def plan_for(m: int, ns: tuple, k: int, out_dtype, *operands) -> GemmPlan:
    """The dispatcher's plan for these shapes and operands, checked.  The
    lookup is memoized on the shapes, the alignment, the output dtype and
    ``gemm_plan`` in ``dispatch.plan_memo``, which the dispatcher empties
    whenever its table changes (``reset_cache_state``); ``check_plan`` runs
    on every call."""
    aligned = is_aligned(*operands)
    key = (m, ns, k, aligned, out_dtype, gemm_plan)
    plan = _memo.get(key)
    if plan is None:
        if len(ns) == 1:
            plan = dispatch.select_plan(m, k, ns[0], out_dtype=out_dtype,
                                        aligned=aligned)
        else:
            plan = dispatch.select_fused_plan(m, k, ns[0], ns[1],
                                              out_dtype=out_dtype,
                                              aligned=aligned)
        _memo[key] = plan
    check_plan(plan, m, ns, k, aligned)
    return plan


_memo = dispatch.plan_memo


def is_aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % TMA_ALIGN == 0 for t in tensors)


def check_depth(k: int, what: str) -> None:
    if k > MAX_K:
        raise ValueError(f"{what}: K = {k} may overflow the int32 sum "
                         f"(at most {MAX_K})")


def check_operand(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: kernel needs a contiguous tensor")


def check_weight(t: torch.Tensor, shape, what: str) -> None:
    """An int8 (K, N) weight stored K-major: the view of an (N, K)-
    contiguous tensor."""
    if t.dtype != torch.int8:
        raise TypeError(f"{what}: expected torch.int8, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.t().is_contiguous():
        raise ValueError(f"{what}: the kernel reads weights K-major, the (K, N) "
                         "view of an (N, K)-contiguous tensor "
                         "(core.quantization.k_major)")


def row_scale(a: QTensor) -> torch.Tensor:
    """A's per-row (or per-tensor) scale as a contiguous (M, 1) f32."""
    m = a.values.shape[0]
    return torch.broadcast_to(a.scale.float(), (m, 1)).contiguous()


def col_scale(b: QTensor) -> torch.Tensor:
    """B's per-column (or per-tensor) scale as a contiguous (1, N) f32."""
    n = b.values.shape[1]
    return torch.broadcast_to(b.scale.float(), (1, n)).contiguous()


def split_scratch(plan: GemmPlan, m: int, n_total: int, dev):
    """The int32 partials (split, M, n_total) of a split K, else None."""
    if plan.split == 1:
        return None
    return torch.empty((plan.split, m, n_total), dtype=torch.int32,
                       device=dev)


def plan_args(plan: GemmPlan) -> tuple:
    """The launcher's integers for ``plan``."""
    return VARIANTS[plan.variant], plan.cols, plan.split, plan.chunk


def tiled_matmul(a: QTensor, b: QTensor, bias: torch.Tensor | None = None, *,
                 out_dtype=torch.bfloat16,
                 plan: GemmPlan | None = None) -> torch.Tensor:
    """C = dequant(A_q @ B_q) + bias for quantized operands.

    ``a``: QTensor (M, K) with per-row (M,1) / per-tensor scale.
    ``b``: QTensor (K, N) with per-col (1,N) / per-tensor scale; on the
    card its values K-major.
    ``bias``: (N,) f32 or None.
    ``plan``: launch this plan (checked like the dispatcher's) instead of
    the dispatcher's: the autotuner measures its candidates so.
    """
    m, k = a.values.shape
    k2, n = b.values.shape
    if k != k2:
        raise ValueError(f"tiled_matmul: inner dims differ ({k} vs {k2})")
    check_depth(k, "tiled_matmul")
    a_scale, b_scale = row_scale(a), col_scale(b)
    dev = a.values.device
    if dev.type == "cpu":
        return _ref.tiled_matmul_ref(a.values, a_scale, b.values, b_scale,
                                     bias, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {dev}")
    no_backward("tiled_matmul (K2)", a.values, a.scale, b.values, b.scale,
                *(() if bias is None else (bias,)))
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"tiled_matmul kernel writes f32 or bf16, not {out_dtype}")
    check_operand(a.values, torch.int8, (m, k), "A values")
    check_weight(b.values, (k, n), "B values")
    if bias is not None:
        check_operand(bias, torch.float32, (n,), "bias")
    for t in (b.values, a_scale, b_scale) + ((bias,) if bias is not None else ()):
        if t.device != dev:
            raise ValueError(f"tiled_matmul: operand on {t.device}, A on {dev}")
    if plan is None:
        plan = plan_for(m, (n,), k, out_dtype, a.values, b.values)
    else:
        check_plan(plan, m, (n,), k, is_aligned(a.values, b.values))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ws = split_scratch(plan, m, n, dev)
    fn = _build.library("int8_gemm").launch_tiled_matmul
    _build.check(fn(a.values.data_ptr(), a_scale.data_ptr(),
                    b.values.data_ptr(), b_scale.data_ptr(),
                    bias.data_ptr() if bias is not None else None,
                    out.data_ptr(), ws.data_ptr() if ws is not None else None,
                    m, k, n, int(out_dtype == torch.bfloat16),
                    *plan_args(plan), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "tiled_matmul")
    tiled_matmul.launches += 1
    tiled_matmul.plans[plan.variant] += 1
    tiled_matmul.launched_plans[plan] += 1
    return out


def _check_b(a: QTensor, b: QTensor, what: str) -> tuple[int, int, int]:
    m, k = a.values.shape
    k2, n = b.values.shape
    if k != k2:
        raise ValueError(f"{what}: inner dims differ ({k} vs {k2})")
    check_depth(k, what)
    return m, k, n


def tiled_matmul_int32(a: QTensor, b: QTensor, *,
                       plan: GemmPlan | None = None) -> torch.Tensor:
    """The exact int32 product (M, N) of A_q (M, K) and B_q (K, N), their
    scales unused: K2's int32-out mode.  On the card it runs the swap
    variant (``swap_plan``, or ``plan``), needs K a multiple of 16 and
    16-byte aligned operands, and B K-major."""
    what = "tiled_matmul_int32"
    m, k, n = _check_b(a, b, what)
    dev = a.values.device
    if dev.type == "cpu":
        return _ref.int_matmul_exact(a.values, b.values)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    no_backward(f"{what} (K2)", a.values, b.values)
    check_operand(a.values, torch.int8, (m, k), "A values")
    check_weight(b.values, (k, n), "B values")
    if b.values.device != dev:
        raise ValueError(f"{what}: B on {b.values.device}, A on {dev}")
    aligned = is_aligned(a.values, b.values)
    plan = plan or swap_plan(m, (n,), k)
    check_plan(plan, m, (n,), k, aligned)
    if plan.variant != "swap":
        raise ValueError(f"{what}: the int32-out mode runs the swap "
                         f"variant, not {plan}")
    a_scale, b_scale = row_scale(a), col_scale(b)
    acc = torch.empty((m, n), dtype=torch.int32, device=dev)
    ws = split_scratch(plan, m, n, dev)
    fn = _build.library("int8_gemm").launch_tiled_matmul_int32
    _build.check(fn(a.values.data_ptr(), a_scale.data_ptr(),
                    b.values.data_ptr(), b_scale.data_ptr(), acc.data_ptr(),
                    ws.data_ptr() if ws is not None else None, m, k, n,
                    plan.cols, plan.split, plan.chunk, dev.index,
                    torch.cuda.current_stream(dev).cuda_stream), what)
    tiled_matmul_int32.launches += 1
    return acc


def int8_epilogue(acc: torch.Tensor, a_scale: torch.Tensor, b: QTensor,
                  bias: torch.Tensor | None = None, *,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """K2's epilogue alone: ``acc.f32 * (sa * sb)`` (+ bias), cast to
    ``out_dtype``, for an int32 product acc (M, N), A's (M, 1) scale and
    the weight ``b``'s (1, N) scale.  Bitwise the epilogue of every K2
    variant."""
    what = "int8_epilogue"
    m, n = acc.shape
    sa = torch.broadcast_to(a_scale.float(), (m, 1)).contiguous()
    sb = col_scale(b)
    if sb.shape[1] != n:
        raise ValueError(f"{what}: acc ({m}, {n}) vs weight scale "
                         f"{tuple(sb.shape)}")
    dev = acc.device
    if dev.type == "cpu":
        return _ref.int8_epilogue_ref(acc, sa, sb, bias, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{what} kernel writes f32 or bf16, not {out_dtype}")
    check_operand(acc, torch.int32, (m, n), "acc")
    if bias is not None:
        check_operand(bias, torch.float32, (n,), "bias")
    for t in (sa, sb) + ((bias,) if bias is not None else ()):
        if t.device != dev:
            raise ValueError(f"{what}: operand on {t.device}, acc on {dev}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.library("int8_gemm").launch_int8_epilogue
    _build.check(fn(acc.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                    bias.data_ptr() if bias is not None else None,
                    out.data_ptr(), m, n, int(out_dtype == torch.bfloat16),
                    dev.index, torch.cuda.current_stream(dev).cuda_stream),
                 what)
    int8_epilogue.launches += 1
    return out


tiled_matmul_int32.launches = 0
int8_epilogue.launches = 0
tiled_matmul.launches = 0
# launches by variant since the last reset_launch_counts(): the served
# paths must plan onto the tensor-core variants
tiled_matmul.plans = collections.Counter()
# launches by whole plan (GemmPlan) since the last reset
tiled_matmul.launched_plans = collections.Counter()
