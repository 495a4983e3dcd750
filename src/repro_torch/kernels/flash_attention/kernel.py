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

Pure Python, the same arithmetic as the JAX package's schedule, so the two
are held equal value for value.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.flash_attention.decode import ceil_div

__all__ = ["FlashSchedule", "flash_schedule", "KERNEL_Q_TILE",
           "KERNEL_KV_TILE", "round_up"]

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
