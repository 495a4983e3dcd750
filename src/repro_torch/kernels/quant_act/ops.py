"""Wrappers for fused activation quantization: CUDA kernel K1 on the card,
the plain versions on the CPU.

``quant_act(x)`` quantizes each row of x to int8; ``quant_act_glu(gate,
up)`` quantizes ``F.silu(gate) * up`` in the same launch, so the SwiGLU
product never reaches device memory on its way to the down projection.
For a row split over the ranks of a serving mesh, ``row_absmax`` (K1's
absmax mode, of x or of the SwiGLU product) gives each part's absmax, and
``quant_act(x, absmax=)`` / ``quant_act_glu(gate, up, absmax=)`` (the
given-absmax mode) quantize a part with the maximum over the parts:
bitwise the whole row's quantization.

``quant_plan`` maps rows onto the card from the shapes and the operands'
alignment alone, before launch (see ``csrc/quant_act.cu``):

* ``block``: one block a row;
* ``cluster``: a row split over a cluster of 2-8 blocks that share their
  slices' maxima through distributed shared memory (too few rows to fill
  the SMs, or a row longer than a block holds).

Each thread holds its share of a row in registers between the absmax and
the quantize: vectors of 8 values (16-byte loads, 8-byte stores) where K
is a multiple of 8 and the bases are 16-byte aligned (``vec`` 8), else one
value an access (``vec`` 1).  ``check_plan`` holds a plan to the shapes
before launch, and the C launcher checks it again against its own
geometry: a plan whose slices do not cover each row exactly once raises.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import _build, no_backward
from repro_torch.kernels.quant_act import ref as _ref

__all__ = ["quant_act", "quant_act_glu", "row_absmax", "quant_plan",
           "check_plan", "candidate_plans", "QuantPlan"]

DTYPES = (torch.float32, torch.bfloat16)
QMAX = 127
SMS = 132                       # H100 SXM streaming multiprocessors
VEC = 8                         # values a vector access moves
VEC_ALIGN = 16                  # bytes: a vector load's alignment
MAX_THREADS = 512
MAX_SPLIT = 8                   # blocks a cluster (the portable size)
ROWS = {"block": 0, "cluster": 1}
# the launcher's modes (csrc/quant_act.cu)
QUANTIZE, ABSMAX, GIVEN = 0, 1, 2
# quant_plan's thresholds, from H100 timings of every mapping at the served
# shapes (`chip_smoke.py` phase 6, PERF.md §6): below LATENCY_ROWS rows a
# launch's latency decides; from it, each thread holds PER vectors
LATENCY_ROWS = 8 * SMS
PER = 4


def max_per(dtype: torch.dtype, vec: int) -> int:
    """Vectors (``vec`` 1: values) a thread can hold in registers: the
    kernel's ``Cap``."""
    if vec == 1:
        return 16
    return 8 if dtype == torch.bfloat16 else 4


class QuantPlan(NamedTuple):
    rows: str                   # "block" or "cluster"
    vec: int                    # values an access: 8 or 1
    threads: int                # a block's threads
    split: int                  # blocks a row (a cluster when > 1)
    per: int                    # vectors (vec 1: values) a thread holds

    def __str__(self) -> str:
        return (f"{self.rows} {self.split}x{self.threads} v{self.vec} "
                f"p{self.per}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec_units(k: int, aligned: bool) -> tuple[int, int]:
    vec = VEC if aligned and k % VEC == 0 else 1
    return vec, k // vec


def _block_plan(units: int, split: int, vec: int, cap: int, per: int, *,
                strict: bool = False) -> QuantPlan | None:
    """A row of ``units`` vectors over ``split`` blocks of the fewest
    threads (a multiple of 32) at which each holds ``per`` vectors of its
    slice.  Where that takes more than MAX_THREADS threads: None if
    ``strict``, else the fewest vectors a thread that MAX_THREADS threads
    allow, on as few threads as hold them.  None where a slice would be
    empty or a share exceed ``cap``."""
    slice_ = _cdiv(units, split)
    if (split - 1) * slice_ >= units:
        return None
    if _cdiv(slice_, per) > MAX_THREADS:
        if strict:
            return None
        per = _cdiv(slice_, MAX_THREADS)
    if per > cap:
        return None
    threads = max(32, _cdiv(_cdiv(slice_, per), 32) * 32)
    return QuantPlan("block" if split == 1 else "cluster", vec, threads,
                     split, per)


def quant_plan(m: int, k: int, dtype: torch.dtype, aligned: bool
               ) -> QuantPlan:
    """K1's row mapping for x (m, k) of ``dtype``, from the shapes and
    whether the operands' bases are 16-byte aligned.

    Below LATENCY_ROWS rows: one block a row, each thread holding one
    vector where MAX_THREADS threads hold the row; else, where the rows
    give fewer than two blocks an SM (m < 2 SMS), a cluster of
    ceil(2 SMS / m) blocks (2-8) a row, each thread holding as few as its
    block allows; else one block of at most MAX_THREADS.  From
    LATENCY_ROWS rows: one block a row whose threads hold PER vectors
    each, or the cap, at most MAX_THREADS threads; a row no such block
    holds splits over the fewest blocks that do."""
    return _quant_plan(m, k, dtype, aligned)


@functools.lru_cache(maxsize=None)
def _quant_plan(m: int, k: int, dtype: torch.dtype, aligned: bool
                ) -> QuantPlan:
    if k < 1:
        raise ValueError(f"quant_act: K must be positive, got {k}")
    vec, units = _vec_units(k, aligned)
    cap = max_per(dtype, vec)
    if m < LATENCY_ROWS:
        first = 1
        if units > MAX_THREADS and m < 2 * SMS:
            first = min(MAX_SPLIT, max(2, _cdiv(2 * SMS, max(m, 1))))
        for split in range(first, MAX_SPLIT + 1):
            plan = _block_plan(units, split, vec, cap, 1)
            if plan is not None:
                return plan
    else:
        for split in range(1, MAX_SPLIT + 1):
            for per in (PER, cap):
                plan = _block_plan(units, split, vec, cap, per, strict=True)
                if plan is not None:
                    return plan
    raise ValueError(f"quant_act: no row mapping holds K = {k} ({dtype}, "
                     f"{vec} values an access) in {MAX_SPLIT} blocks of "
                     f"{MAX_THREADS} threads")


def candidate_plans(m: int, k: int, dtype: torch.dtype, aligned: bool
                    ) -> list[QuantPlan]:
    """Every mapping worth timing at these shapes: one block a row or
    clusters of 2, 4 and 8 blocks, each at about 1, 2, 4 and 8 vectors a
    thread; with ``quant_plan``'s own (`chip_smoke.py` phase 6 times them
    against each other)."""
    vec, units = _vec_units(k, aligned)
    cap = max_per(dtype, vec)
    plans = []
    for split in (1, 2, 4, 8):
        for per in (1, 2, 4, 8):
            plan = _block_plan(units, split, vec, cap, per)
            if plan is not None:
                plans.append(plan)
    return list(dict.fromkeys(plans + [quant_plan(m, k, dtype, aligned)]))


def check_plan(plan: QuantPlan, m: int, k: int, dtype: torch.dtype,
               aligned: bool) -> None:
    """Raise unless the kernel takes ``plan`` at these shapes: vector
    accesses only where K is a multiple of 8 and the bases aligned; a
    block of 32-512 threads; one block a row, or 2-8 for a cluster; a
    thread's share within its registers; the slices covering each row's
    vectors exactly once (the last slice not empty)."""
    vec_ok = plan.vec == 1 or (plan.vec == VEC and aligned and k % VEC == 0)
    ok = (vec_ok and k >= 1 and plan.rows in ROWS
          and 32 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
          and 1 <= plan.per <= max_per(dtype, plan.vec)
          and (2 <= plan.split <= MAX_SPLIT if plan.rows == "cluster"
               else plan.split == 1)
          and m * plan.split < 2 ** 31)
    if ok:
        units = k // plan.vec
        slice_ = _cdiv(units, plan.split)
        ok = (plan.split - 1) * slice_ < units <= plan.split * slice_ \
            and plan.per * plan.threads >= slice_
    if not ok:
        raise ValueError(f"quant_act: plan {plan!r} does not fit x ({m}, {k}) "
                         f"{dtype}{'' if aligned else ' (unaligned)'}")


def is_aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % VEC_ALIGN == 0 for t in tensors)


def _check_matrix(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what} takes a 2-D (M, K) matrix, got "
                         f"{tuple(x.shape)}")


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous input")


def _check_absmax(absmax: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if (absmax.dtype != torch.float32 or tuple(absmax.shape) != (x.shape[0], 1)
            or absmax.device != x.device):
        raise ValueError(f"{what}: absmax must be ({x.shape[0]}, 1) f32 on "
                         f"{x.device}, got {tuple(absmax.shape)} "
                         f"{absmax.dtype} on {absmax.device}")


def _launch(x: torch.Tensor, up: torch.Tensor | None,
            h_out: torch.Tensor | None, what: str, mode: int = QUANTIZE,
            absmax: torch.Tensor | None = None):
    """One K1 launch on CUDA tensors (the SwiGLU mode with ``up``); returns
    (values, scale, plan); in the absmax mode (values None, the rows'
    absmax, plan)."""
    m, k = x.shape
    aligned = is_aligned(*(t for t in (x, up, h_out) if t is not None))
    plan = quant_plan(m, k, x.dtype, aligned)
    check_plan(plan, m, k, x.dtype, aligned)
    values = (None if mode == ABSMAX else
              torch.empty((m, k), dtype=torch.int8, device=x.device))
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if absmax is not None:
        absmax = absmax.contiguous()
    fn = _build.library("quant_act").launch_quant_act
    _build.check(fn(x.data_ptr(), None if up is None else up.data_ptr(),
                    None if values is None else values.data_ptr(),
                    scale.data_ptr(),
                    None if h_out is None else h_out.data_ptr(),
                    None if absmax is None else absmax.data_ptr(), m, k,
                    QMAX, int(x.dtype == torch.bfloat16), int(up is not None),
                    plan.vec, ROWS[plan.rows], plan.threads, plan.split,
                    plan.per, mode, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream), what)
    return values, scale, plan


def _check_glu(gate: torch.Tensor, up: torch.Tensor, what: str) -> None:
    _check_matrix(gate, what)
    if up.shape != gate.shape or up.dtype != gate.dtype \
            or up.device != gate.device:
        raise ValueError(f"{what}: up {tuple(up.shape)} {up.dtype} "
                         f"on {up.device} differs from gate "
                         f"{tuple(gate.shape)} {gate.dtype} on {gate.device}")


def row_absmax(x: torch.Tensor, up: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Each row's absmax in f32, (M, 1), of x (M, K), or with ``up`` of the
    SwiGLU product ``F.silu(x) * up``: K1's absmax mode, one launch."""
    what = "row_absmax"
    if up is None:
        _check_matrix(x, what)
    else:
        _check_glu(x, up, what)
    if x.device.type == "cpu":
        return (_ref.row_absmax_ref(x) if up is None
                else _ref.row_absmax_glu_ref(x, up))
    for t in (x,) + (() if up is None else (up,)):
        _check_cuda(t, what)
    no_backward("row_absmax (K1)", x, *(() if up is None else (up,)))
    _, absmax, _ = _launch(x, up, None, what, ABSMAX)
    row_absmax.launches += 1
    return absmax


def quant_act(x: torch.Tensor, *, absmax: torch.Tensor | None = None
              ) -> QTensor:
    """Per-row int8 quantization of a 2-D activation matrix (M, K);
    ``absmax`` (M, 1) f32, where given, in place of the rows' own."""
    _check_matrix(x, "quant_act")
    if absmax is not None:
        _check_absmax(absmax, x, "quant_act")
    if x.device.type == "cpu":
        values, scale = _ref.quant_act_ref(x, absmax=absmax)
        return QTensor(values=values, scale=scale, bits=8)
    _check_cuda(x, "quant_act")
    no_backward("quant_act (K1)", x)
    values, scale, plan = _launch(x, None, None, "quant_act",
                                  QUANTIZE if absmax is None else GIVEN,
                                  absmax)
    quant_act.launches += 1
    quant_act.plans[str(plan)] += 1
    return QTensor(values=values, scale=scale, bits=8)


def quant_act_glu(gate: torch.Tensor, up: torch.Tensor, *,
                  h_out: torch.Tensor | None = None,
                  absmax: torch.Tensor | None = None) -> QTensor:
    """Per-row int8 quantization of ``F.silu(gate) * up``, both (M, K) of
    one dtype: the SwiGLU FFN's input to its down projection.  ``h_out``,
    where given (a check of the kernel's prologue), receives the product
    itself; ``absmax`` (M, 1) f32, where given, replaces the rows' own."""
    _check_glu(gate, up, "quant_act_glu")
    if absmax is not None:
        _check_absmax(absmax, gate, "quant_act_glu")
    if h_out is not None and (h_out.shape != gate.shape
                              or h_out.dtype != gate.dtype
                              or h_out.device != gate.device):
        raise ValueError("quant_act_glu: h_out must match gate")
    if gate.device.type == "cpu":
        if h_out is not None:
            h_out.copy_(F.silu(gate) * up)
        values, scale = _ref.quant_act_glu_ref(gate, up, absmax=absmax)
        return QTensor(values=values, scale=scale, bits=8)
    for t in (gate, up) + (() if h_out is None else (h_out,)):
        _check_cuda(t, "quant_act_glu")
    no_backward("quant_act_glu (K1)", gate, up)
    values, scale, plan = _launch(gate, up, h_out, "quant_act_glu",
                                  QUANTIZE if absmax is None else GIVEN,
                                  absmax)
    quant_act_glu.launches += 1
    quant_act_glu.plans[str(plan)] += 1
    return QTensor(values=values, scale=scale, bits=8)


quant_act.launches = 0
quant_act_glu.launches = 0
row_absmax.launches = 0
# launches by plan since the last reset_launch_counts()
quant_act.plans = collections.Counter()
quant_act_glu.plans = collections.Counter()
