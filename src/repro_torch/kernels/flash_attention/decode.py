"""Schedule of the paged flash-decode kernel (K4): which pages each q block
walks.

A decode or cache-writing step attends ``q_len`` new rows per sequence
over a page pool addressed through a page table.  The rows are processed
in q blocks of ``q_chunk`` rows, and block ``i`` of a sequence with
``ctx`` committed tokens (the step's rows included) walks only the
logical pages ``[j_lo, j_hi]`` its causal horizon and sliding window
expose.  The CUDA kernel (``csrc/paged_decode.cu``) computes the same
bounds per block; ``pages_touched`` counts the pages it streams.  The
kernel cuts each block's walk over several CUDA blocks (flash-decoding):
``split_plan`` sizes that cut from the launch's shapes alone, and
``split_bounds`` gives each split's pages.

Pure Python, the same arithmetic as the JAX package's schedule, so the
two are held equal value for value.
"""
from __future__ import annotations

import dataclasses

__all__ = ["FlashDecodeSchedule", "flash_decode_schedule", "pages_touched",
           "ceil_div", "SplitPlan", "split_plan", "split_bounds"]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FlashDecodeSchedule:
    """Static plan for one paged attention launch.

    ``max_steps`` is the page budget per q block (the page-table width,
    pruned by the sliding window); the pages actually walked are the
    per-(sequence, block) ``[j_lo, j_hi]`` ranges that ``pages_touched``
    counts.  ``q_len`` new rows per sequence run as ``num_q_blocks``
    blocks of ``q_chunk`` rows (one block for plain decode).
    """

    page_size: int
    max_pages: int
    q_len: int
    window: int | None
    max_steps: int
    q_chunk: int = 1
    num_q_blocks: int = 1


def flash_decode_schedule(max_pages: int, page_size: int, *,
                          q_len: int = 1,
                          window: int | None = None,
                          q_chunk: int | None = None) -> FlashDecodeSchedule:
    """Plan the paged KV walk for a decode / chunked-prefill step.

    ``q_chunk`` rows per block defaults to all of ``q_len``.  A window
    bounds each q block's visible span to ``q_chunk + window - 1`` tokens
    and so its page span to ``ceil(span / page_size) + 1`` (the +1 covers
    an unaligned window straddling one more page boundary).
    """
    assert max_pages >= 1 and page_size >= 1 and q_len >= 1
    q_chunk = min(q_chunk or q_len, q_len)
    num_q_blocks = ceil_div(q_len, q_chunk)
    max_steps = max_pages
    if window is not None:
        span = q_chunk + window - 1
        max_steps = min(max_pages, ceil_div(span, page_size) + 1)
    return FlashDecodeSchedule(page_size=page_size, max_pages=max_pages,
                               q_len=q_len, window=window,
                               max_steps=max_steps, q_chunk=q_chunk,
                               num_q_blocks=num_q_blocks)


def _page_bounds(ctx: int, i: int, *, q_len: int, q_chunk: int,
                 page_size: int, window: int | None) -> tuple[int, int]:
    """Inclusive [j_lo, j_hi] logical-page range visible to q block ``i``
    of a context of ``ctx`` tokens (the step's ``q_len`` rows occupy
    positions ``ctx - q_len .. ctx - 1``; block ``i`` holds rows
    ``i*q_chunk .. (i+1)*q_chunk - 1`` of those)."""
    base = ctx - q_len
    last = min(base + (i + 1) * q_chunk - 1, ctx - 1)
    j_hi = max(last, 0) // page_size
    j_lo = 0
    if window is not None:
        # first k visible to the block's oldest row (pos base + i*q_chunk):
        # k > pos - window  =>  k_min = max(pos - window + 1, 0)
        first_k = max(base + i * q_chunk - window + 1, 0)
        j_lo = min(first_k // page_size, j_hi)
    return j_lo, j_hi


def pages_touched(lengths, sched: FlashDecodeSchedule) -> int:
    """Pages walked for one step over a batch of context lengths (the
    step's new tokens included), per KV head.  Sums over the q blocks: a
    chunked prefill walks early pages once per later block, as the kernel
    does."""
    total = 0
    for ctx in lengths:
        for i in range(sched.num_q_blocks):
            j_lo, j_hi = _page_bounds(int(ctx), i, q_len=sched.q_len,
                                      q_chunk=sched.q_chunk,
                                      page_size=sched.page_size,
                                      window=sched.window)
            total += j_hi - j_lo + 1
    return total


# The CUDA kernel's split of the page walk: q rows per CUDA block (kRows in
# csrc/paged_decode.cu); a split walks whole pages, at least
# SPLIT_MIN_KEYS keys and, where the walk is long, about SPLIT_MAX_KEYS;
# short walks split further until the grid has SPLIT_FILL_BLOCKS blocks
# (two per SM of an H100's 132).
SPLIT_ROW_TILE = 16
SPLIT_MIN_KEYS = 64
SPLIT_MAX_KEYS = 256
SPLIT_FILL_BLOCKS = 264


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Each q block's walk ``[j_lo, j_hi]`` runs as ``n_splits`` chunks of
    ``pages_per_split`` logical pages from ``j_lo`` (the last chunk takes
    the rest); ``n_splits == 1`` writes the output directly, more write
    partials that a second kernel combines."""

    pages_per_split: int
    n_splits: int


def split_plan(batch: int, n_kv: int, group: int,
               sched: FlashDecodeSchedule) -> SplitPlan:
    """The split of one launch, from its shapes alone (``batch`` sequences,
    ``n_kv`` KV heads of ``group`` query heads each, the schedule's page
    budget ``max_steps``), never from the lengths: equal shapes give equal
    splits, whatever the pools' dtype, the page ids or the verify mode."""
    span = sched.max_steps
    blocks = max(1, batch * n_kv * sched.num_q_blocks
                 * ceil_div(group * sched.q_chunk, SPLIT_ROW_TILE))
    most = ceil_div(span, ceil_div(SPLIT_MIN_KEYS, sched.page_size))
    want = max(ceil_div(SPLIT_FILL_BLOCKS, blocks),
               ceil_div(span * sched.page_size, SPLIT_MAX_KEYS))
    pages = ceil_div(span, max(1, min(most, want)))
    return SplitPlan(pages_per_split=pages, n_splits=ceil_div(span, pages))


def split_bounds(j_lo: int, j_hi: int, split: int,
                 plan: SplitPlan) -> tuple[int, int]:
    """Inclusive logical pages of ``split`` within a q block's walk
    ``[j_lo, j_hi]``; empty (hi < lo) for a split past ``j_hi``."""
    lo = j_lo + split * plan.pages_per_split
    hi = (j_hi if split == plan.n_splits - 1
          else min(lo + plan.pages_per_split - 1, j_hi))
    return lo, hi
