"""Schedule of the block-sparse flash-attention kernel (K5): which KV blocks
each q block streams.

A cache-less attention of S query rows over T key rows runs in q blocks of
``q_chunk`` rows; block ``i`` walks only the KV blocks ``[j_lo, j_hi]`` its
causal horizon and sliding window expose (``_kv_block_bounds``), so a fully
masked KV block is never loaded.  ``flash_schedule`` plans that sweep and
counts it: ``blocks_touched`` is the exact number of KV blocks streamed,
``blocks_dense`` that of the rectangular sweep.

The CUDA kernel (``csrc/flash_attention.cu``) computes the same bounds per
block at its own tile sizes, ``KERNEL_Q_TILE`` x ``KERNEL_KV_TILE``: its
walk is ``flash_schedule(S, T, q_chunk=KERNEL_Q_TILE,
kv_chunk=KERNEL_KV_TILE, ...)``.  The ``q_chunk``/``kv_chunk`` a caller
passes to the wrapper plan this counter only.

K5's backward (``csrc/flash_attention_bwd.cu``) walks the same pairs
transposed in its bf16 dK dV kernel: KV tile ``j`` visits the q tiles
``q_tile_bounds`` gives, the inverse of ``_kv_block_bounds``, its blocks
launched in ``dkdv_tile_order``; ``bwd_scratch_floats`` sizes the scratch
its wrapper allocates.

Pure Python, the same arithmetic as the JAX package's schedule, so the two
are held equal value for value.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.flash_attention.decode import ceil_div

__all__ = ["FlashSchedule", "flash_schedule", "KERNEL_Q_TILE",
           "KERNEL_KV_TILE", "round_up", "q_tile_bounds", "dkdv_tile_order",
           "bwd_scratch_floats"]

# the CUDA kernel's tile: q rows per block, KV rows per step of its walk
KERNEL_Q_TILE = 64
KERNEL_KV_TILE = 64


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class FlashSchedule:
    """Static block schedule for one (S, T, chunk, mask-structure) problem.

    ``max_kv_steps`` is the longest walk of any q block; ``blocks_touched``
    counts the KV blocks streamed over all q blocks (the block-sparse sweep
    skips fully masked ones) against ``blocks_dense = num_q_blocks *
    num_kv_blocks``.
    """

    s_len: int
    t_len: int
    q_chunk: int
    kv_chunk: int
    causal: bool
    window: int | None
    num_q_blocks: int
    num_kv_blocks: int
    max_kv_steps: int
    blocks_touched: int
    blocks_dense: int


def _kv_block_bounds(i: int, *, q_chunk: int, kv_chunk: int, num_kv: int,
                     causal: bool, window: int | None) -> tuple[int, int]:
    """Inclusive [j_lo, j_hi] KV-block range visible to q block ``i``."""
    j_lo = 0
    if window is not None:
        # lowest k visible to the block's first row i*qc: k > i*qc - window
        first_k = max(i * q_chunk - (window - 1), 0)
        j_lo = min(first_k // kv_chunk, num_kv - 1)
    j_hi = num_kv - 1
    if causal:
        # highest k visible to the block's last row: k <= (i+1)*qc - 1
        j_hi = min(((i + 1) * q_chunk - 1) // kv_chunk, num_kv - 1)
    return j_lo, j_hi


def flash_schedule(s_len: int, t_len: int, *, q_chunk: int, kv_chunk: int,
                   causal: bool = True,
                   window: int | None = None) -> FlashSchedule:
    """Plan the block-sparse KV sweep for an (S, T) attention problem.

    Chunk sizes are clamped to the 8-aligned sequence lengths and the grids
    ceil-divided (partial chunks are masked, not padded).
    """
    q_chunk = min(q_chunk, round_up(s_len, 8))
    kv_chunk = min(kv_chunk, round_up(t_len, 8))
    num_q = ceil_div(s_len, q_chunk)
    num_kv = ceil_div(t_len, kv_chunk)
    max_steps, touched = 0, 0
    for i in range(num_q):
        j_lo, j_hi = _kv_block_bounds(i, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                      num_kv=num_kv, causal=causal,
                                      window=window)
        steps = j_hi - j_lo + 1
        max_steps = max(max_steps, steps)
        touched += steps
    return FlashSchedule(
        s_len=s_len, t_len=t_len, q_chunk=q_chunk, kv_chunk=kv_chunk,
        causal=causal, window=window, num_q_blocks=num_q,
        num_kv_blocks=num_kv, max_kv_steps=max_steps,
        blocks_touched=touched, blocks_dense=num_q * num_kv)


def q_tile_bounds(j: int, *, q_chunk: int, kv_chunk: int, num_q: int,
                  num_kv: int, causal: bool,
                  window: int | None) -> tuple[int, int]:
    """Inclusive [i_lo, i_hi] of the q blocks whose walk
    (``_kv_block_bounds``) visits KV block ``j``; i_lo > i_hi when none
    does.  Block i visits j iff j <= j_hi(i), i.e. (i + 1) q_chunk > j
    kv_chunk when causal, and j_lo(i) <= j, i.e. i q_chunk < (j + 1)
    kv_chunk + window - 1 with a window unless j is the last block (j_lo is
    capped there).  ``flash_common.cuh``'s ``q_tile_bounds`` at the
    kernel's tiles."""
    i_lo = j * kv_chunk // q_chunk if causal else 0
    i_hi = num_q - 1
    if window is not None and j < num_kv - 1:
        i_hi = min(((j + 1) * kv_chunk + window - 2) // q_chunk, num_q - 1)
    return i_lo, i_hi


def dkdv_tile_order(s_len: int, t_len: int, *, causal: bool,
                    window: int | None) -> list[int]:
    """The KV tiles of the bf16 dK dV kernel in launch order (its grid's y):
    ascending when causal (the walks run to the last q tile and start later
    for later tiles), descending when not (they start at q tile 0 and end
    later for later tiles), so the longest walks start first."""
    num_kv = ceil_div(t_len, KERNEL_KV_TILE)
    return list(range(num_kv)) if causal else list(range(num_kv - 1, -1, -1))


def bwd_scratch_floats(b: int, s_len: int, t_len: int, h: int, kh: int,
                       d: int, *, bf16: bool) -> int:
    """f32 elements of the backward's scratch: D_i (B, H, S), its length
    rounded up to 32 (128 bytes, so what follows is aligned), then in bf16
    with g = H / KH > 1 the g heads' dK and dV shares (B, T, H, D) each,
    which the dK dV kernel writes and a second kernel sums in head order."""
    rows = round_up(b * h * s_len, 32)
    if not bf16 or h == kh:
        return rows
    return rows + 2 * b * t_len * h * d
