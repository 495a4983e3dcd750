"""The Hopper model behind the port's GEMM plans: the counterpart of
``repro.core.tiling``.

The JAX package budgets TPU VMEM and MXU alignment; here the constraints
are the H100's: shared memory a block may take, 132 SMs to fill, and the
HBM bytes a plan moves.  This module holds

  * the H100 SXM data-sheet figures (``chip_smoke.py`` and the wrappers
    read them from here),
  * the geometry of the int8 GEMM kernels K2 / K3 (``csrc/int8_wgmma.cuh``,
    ``csrc/int8_tile.cuh``) and ``GemmPlan``, a launch of one of them,
  * ``choose_plan``, the analytic pick from the shapes alone (the
    wrappers' ``gemm_plan``), and
  * ``PlanModel``, the cost of a plan at a shape (tiles, waves, shared
    memory, HBM bytes, ``time_estimate``), which ranks the autotuner's
    candidates (``core/dispatch.py``) as ``TilePlan.time_estimate`` does
    in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

# --- H100 SXM (dense data-sheet peaks) ------------------------------------
HBM_BYTES_PER_S = 3.35e12         # HBM3
INT8_OPS_PER_S = 1979e12          # int8 tensor cores, 2 ops a MAC
BF16_OPS_PER_S = 989e12           # bf16 tensor cores
F32_OPS_PER_S = 67e12             # f32 ALUs (FFMA)
L2_BYTES = 50 * 2 ** 20
SMS = 132                         # streaming multiprocessors
SMEM_PER_BLOCK = 227 * 1024       # shared memory one block may take
SMEM_PER_SM = 228 * 1024
# what the cost model assumes of the card beyond the data sheet: a DRAM
# round trip under load (bytes in flight per block over it bound a block's
# rate) and a kernel's launch and tail inside a CUDA graph
HBM_LATENCY_S = 1e-6
KERNEL_S = 1.5e-6

# --- the int8 GEMM kernels' geometry (csrc/int8_wgmma.cuh, int8_tile.cuh) --
BK = 128                        # K values per pipeline stage (one k-step)
ROWS = 128                      # wgmma A-side rows per block
WIDE_COLS = 256                 # the wide variant's output columns per block
SWAP_COLS = (8, 16, 32, 64)     # the swap variant's padded activation rows
SWAP_MAX_M = 512                # past this many rows, the wide variant
MIN_SPLIT_STEPS = 4             # k-steps a split takes at least
TMA_ALIGN = 16                  # bytes: TMA's base and row-stride alignment
STAGES = 4                      # the TMA ring's stages
SCALE_FLOATS = 3 * 256          # a tile's staged sb, bias and sa
SLAB_BYTES = 8 * 160            # a wide consumer warp's epilogue slab
GENERAL_TILE = 64               # the __dp4a tile: 64 x 64 outputs, 64 of K
GENERAL_LDB = GENERAL_TILE + 4  # its padded shared row
# the largest K whose int32 sum of int8 products cannot overflow:
# 127^2 K < 2^31
MAX_K = (2 ** 31 - 1) // 127 ** 2
VARIANTS = {"general": 0, "wide": 1, "swap": 2}


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceil_div(x, m) * m


class GemmPlan(NamedTuple):
    variant: str                # "wide", "swap" or "general"
    cols: int                   # wgmma's N: 256, M padded, or 0 (general)
    split: int                  # blocks along K (> 1: int32 partials)
    chunk: int                  # k-steps of BK per split

    @property
    def schedule(self) -> str:
        """``"panel"`` (one block walks all of K) or ``"k_split"`` (K split
        over blocks); compares equal to the ``dispatch.Schedule`` enum."""
        return "panel" if self.split == 1 else "k_split"


@functools.lru_cache(maxsize=None)
def choose_plan(m: int, ns: tuple, k: int, aligned: bool) -> GemmPlan:
    """The analytic plan for A (m, k) times products of widths ``ns`` (one
    for K2; Nq, Nkv, Nkv for K3), from the shapes and whether every
    operand's base is 16-byte aligned.

    The wide variant takes M > 512, and M > 64 where its tiles fill half
    the SMs.  The swap variant splits K only where its tiles leave three
    quarters of the SMs idle, into splits of at least MIN_SPLIT_STEPS
    k-steps: a split costs a second kernel and M x N int32 partials.  The
    thresholds come from H100 timings of each choice
    (`tools/gemm_plan_sweep.py`, PERF.md §6)."""
    if not aligned or k % TMA_ALIGN or m == 0 or min(ns) == 0:
        return GemmPlan("general", 0, 1, 0)
    nk = ceil_div(k, BK)
    wide_tiles = ceil_div(m, ROWS) * sum(ceil_div(n, WIDE_COLS) for n in ns)
    if m > SWAP_MAX_M or (m > SWAP_COLS[-1] and wide_tiles >= SMS // 2):
        return GemmPlan("wide", WIDE_COLS, 1, nk)
    return swap_plan(m, ns, k)


def swap_plan(m: int, ns: tuple, k: int) -> GemmPlan:
    """The swap variant's plan at these shapes (``choose_plan``'s split
    rule), whatever M: K2's int32-out mode takes no other variant."""
    nk = ceil_div(k, BK)
    cols = swap_cols(m)
    tiles = ceil_div(m, cols) * sum(ceil_div(n, ROWS) for n in ns)
    split = 1
    if tiles <= SMS // 4:
        split = max(1, min(SMS // tiles, nk // MIN_SPLIT_STEPS))
    chunk = ceil_div(nk, split)
    return GemmPlan("swap", cols, ceil_div(nk, chunk), chunk)


def swap_cols(m: int) -> int:
    """The swap variant's wgmma N for m activation rows: the smallest of
    SWAP_COLS that holds them, tiles of 64 rows past 64."""
    return next((c for c in SWAP_COLS if c >= m), SWAP_COLS[-1])


def smem_bytes(variant: str, cols: int, nmat: int = 1) -> int:
    """Dynamic (tensor-core variants) or static (general) shared memory of
    one block: the TMA ring's stages of 128 weight-or-activation rows and
    ``cols`` others of BK bytes, their barriers, two tiles' scales, the
    wide form's epilogue slabs and the 1024-byte alignment slack
    (``int8_wgmma::Shape``); the general tile's padded A and ``nmat`` B
    tiles."""
    if variant == "general":
        return GENERAL_TILE * GENERAL_LDB * (1 + nmat)
    swap = cols <= SWAP_COLS[-1]
    stage = ROWS * BK + cols * BK
    slabs = 0 if swap else 4 * (ROWS // 64) * SLAB_BYTES
    return (STAGES * stage + 2 * STAGES * 8 + 2 * SCALE_FLOATS * 4 + slabs
            + 1024)


@dataclasses.dataclass(frozen=True)
class PlanModel:
    """A GemmPlan's cost at A (m, k) times widths ``ns``, out_bytes an
    output element."""
    plan: GemmPlan
    m: int
    ns: tuple
    k: int
    out_bytes: int = 2

    # -- grid ----------------------------------------------------------------
    @property
    def tile(self) -> tuple[int, int]:
        """(activation rows, output columns) of one block's tile."""
        if self.plan.variant == "general":
            return GENERAL_TILE, GENERAL_TILE
        if self.plan.variant == "wide":
            return ROWS, WIDE_COLS
        return self.plan.cols, ROWS

    @property
    def tiles(self) -> int:
        """Output tiles: row tiles times every product's column tiles."""
        tm, tn = self.tile
        return ceil_div(self.m, tm) * sum(ceil_div(n, tn) for n in self.ns)

    @property
    def items(self) -> int:
        """Blocks' work items: a tile's share of K each."""
        return self.tiles * self.plan.split

    @property
    def smem(self) -> int:
        return smem_bytes(self.plan.variant, self.plan.cols, len(self.ns))

    @property
    def fits_smem(self) -> bool:
        return self.smem <= SMEM_PER_BLOCK

    @property
    def blocks_per_sm(self) -> int:
        """Resident blocks an SM (the kernels' ``__launch_bounds__`` minimum
        blocks, capped by shared memory)."""
        want = 2 if self.plan.variant == "swap" else 1
        return max(1, min(want, SMEM_PER_SM // self.smem))

    @property
    def waves(self) -> int:
        """Rounds of the SMs' tensor cores over the work items."""
        return ceil_div(self.items, SMS)

    @property
    def kernels(self) -> int:
        """Launches: a split K sums its partials in a second kernel."""
        return 2 if self.plan.split > 1 else 1

    # -- work and traffic ----------------------------------------------------
    @property
    def ops(self) -> int:
        """int8 ops the tiles execute, padding included."""
        tm, tn = self.tile
        rows = round_up(self.m, tm)
        cols = sum(round_up(n, tn) for n in self.ns)
        return 2 * rows * cols * round_up(self.k, BK if self.plan.variant
                                          != "general" else GENERAL_TILE)

    @property
    def hbm_bytes(self) -> int:
        """Bytes to and from HBM: A, the weights and both scales once, the
        outputs once, and a split's int32 partials (split x M x N x 4)
        written and read back."""
        n_all = sum(self.ns)
        b = (self.m * self.k + self.k * n_all + 4 * (self.m + n_all)
             + self.out_bytes * self.m * n_all)
        if self.plan.split > 1:
            b += 2 * self.plan.split * self.m * n_all * 4
        return b

    def time_estimate(self) -> float:
        """Seconds: the larger of the tensor cores' time over the waves of
        padded tiles and the bytes' time at the rate the resident blocks
        can pull (their stages in flight over a DRAM round trip, at most
        HBM's), plus a round trip to fill the pipeline and each kernel's
        launch.  The general tile runs on the ALUs' __dp4a (4 MACs an
        instruction)."""
        if self.plan.variant == "general":
            per_sm = 4 * F32_OPS_PER_S / SMS
            in_flight = self.smem
        else:
            per_sm = INT8_OPS_PER_S / SMS
            in_flight = STAGES * (ROWS + self.plan.cols) * BK
        compute = self.waves * (self.ops / max(self.items, 1)) / per_sm
        active = min(self.items, SMS * self.blocks_per_sm)
        rate = min(HBM_BYTES_PER_S, active * in_flight / HBM_LATENCY_S)
        return (max(compute, self.hbm_bytes / rate) + HBM_LATENCY_S
                + self.kernels * KERNEL_S)
