"""Dynamic page allocator and prefix-sharing tables for the paged KV cache.

The kernel addresses KV only through the page table, so physical
placement is free: instead of a static rectangle of pages per sequence, a
free-list allocator hands pages out at admission and takes them back at
retirement, so a pool can serve an unbounded stream of requests
(``serving/scheduler.py``), and two sequences with a common prompt prefix
can share the prefix's pages.

The state is small int32 tensors on the cache's device, kept in the cache
dict as ``alloc_free`` / ``alloc_top`` / ``alloc_ref`` plus ``alloc_held``
(B,) — how many leading ``page_table`` entries each row references:

  free stack   (1, P) int32  ``free[0, :top[0]]`` are the free page ids
  top          (1,)   int32  free pages (the stack pointer)
  refcounts    (1, P) int32  live references per page (0 = free)

The leading dimension is the JAX package's shard dimension; the port runs
one shard (per-shard free lists over a mesh wait for ROADMAP queue 1,
item 13).  ``alloc_pages`` / ``free_pages`` / ``share_pages`` are masked
scatters on that state, as in the JAX package, so they read nothing back
to the host; the cache-level helpers (``admit_sequence``,
``fork_sequence``, ...) return ``ok`` as a 0-d bool tensor, and the
scheduler branches on it (a read of one value).

**Reserved scratch page** — page 0 is never allocated (its refcount is
pinned at init).  Idle rows and the unallocated tail of every table row
point at it, so their masked writes land somewhere harmless.

**Prefix sharing** — ``fork_sequence`` builds a child row whose first
``prefix_len // page_size`` entries alias the parent's pages (refcount +
1, read-only from then on); the partially filled boundary page is copied
into a private child page at fork time, in every ``PAGE_STATE_KEYS``
array, since the child's first write lands mid-page.  So writes only ever
reach pages of refcount 1.  ``free_sequence`` drops one reference along
the row and returns to the stack only the pages that reach zero.

The pools and the allocator state are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.decode import ceil_div
from repro_torch.serving.cache import PAGE_STATE_KEYS, SCRATCH_PAGE

__all__ = ["ALLOC_KEYS", "SCRATCH_PAGE", "init_allocator", "alloc_pages",
           "free_pages", "share_pages", "attach_allocator",
           "allocator_state", "store_allocator", "require_allocator",
           "pool_occupancy", "admit_sequence", "free_sequence",
           "fork_sequence"]

_RESERVED = 1             # pages [0, _RESERVED) are pinned at init

ALLOC_KEYS = ("alloc_free", "alloc_top", "alloc_ref", "alloc_held")


# ---------------------------------------------------------------------------
# free-list operations on the state {"free", "top", "ref"}
# ---------------------------------------------------------------------------
def init_allocator(n_pages: int, shards: int = 1, *, device="cpu") -> dict:
    """Fresh allocator over a pool of ``n_pages`` pages: free pages stacked
    ascending (the top of the stack is the highest id, so early
    allocations land at the far end of the pool), the scratch page
    pinned.  Only ``shards=1``: per-shard free lists come with mesh
    sharding (ROADMAP queue 1, item 13)."""
    if shards != 1:
        raise NotImplementedError(
            f"allocator over {shards} pool shards: per-shard free lists "
            "come with mesh sharding (ROADMAP queue 1, item 13)")
    if n_pages <= _RESERVED:
        raise ValueError(f"a pool of {n_pages} pages is all reserved")
    ids = torch.arange(n_pages, dtype=torch.int32, device=device)
    # [1..P-1, pad 0]: the scratch page is not on the stack
    free = torch.where(ids < n_pages - _RESERVED, ids + _RESERVED,
                       torch.zeros_like(ids))[None]
    top = torch.tensor([n_pages - _RESERVED], dtype=torch.int32,
                       device=device)
    ref = torch.zeros((1, n_pages), dtype=torch.int32, device=device)
    ref[0, SCRATCH_PAGE] = 1
    return {"free": free, "top": top, "ref": ref}


def _add_refs(ref: torch.Tensor, pages: torch.Tensor, take: torch.Tensor,
              delta: int) -> torch.Tensor:
    """``ref`` (1, P) with ``delta`` added at ``pages[take]`` (no host
    read: untaken entries land in a dropped extra slot)."""
    n = ref.shape[1]
    flat = torch.cat([ref.reshape(-1), ref.new_zeros(1)])
    idx = torch.where(take, pages.long(), n)
    flat = flat.index_add(0, idx, torch.full_like(idx, delta,
                                                  dtype=ref.dtype))
    return flat[:n].reshape(1, n)


def alloc_pages(state: dict, n: int, width: int):
    """Pop ``n`` pages into a ``(width,)`` table row of page ids (entries
    past ``n`` are scratch).  Returns ``(state, row, ok)``; when ``ok`` is
    False the state is unchanged and the row all scratch."""
    free, top, ref = state["free"], state["top"], state["ref"]
    n = int(n)
    ok = top[0] - n >= 0
    j = torch.arange(width, dtype=torch.int32, device=top.device)
    take = (j < n) & ok
    idx = (top[0] - 1 - j).clamp(0, free.shape[1] - 1).long()
    row = torch.where(take, free[0, idx], SCRATCH_PAGE)
    ref = _add_refs(ref, row, take, 1)
    top = torch.where(ok, top - n, top)
    return {"free": free, "top": top, "ref": ref}, row, ok


def free_pages(state: dict, row: torch.Tensor, count) -> dict:
    """Drop one reference from the first ``count`` entries of ``row``;
    pages whose refcount reaches zero go back on the free stack."""
    free, top, ref = state["free"], state["top"], state["ref"]
    per = free.shape[1]
    held = torch.arange(row.shape[0], device=row.device) < count
    ref = _add_refs(ref, row, held, -1)
    released = held & (ref[0, row.long()] == 0)
    # the k-th released page of the row lands at free[0, top + k]
    rank = torch.cumsum(released.to(torch.int32), 0) - 1
    pos = top[0] + rank
    safe = released & (pos < per)
    flat = torch.cat([free.reshape(-1), free.new_zeros(1)])
    flat[torch.where(safe, pos.long(), per)] = row.to(free.dtype)
    top = top + released.sum().to(top.dtype)
    return {"free": flat[:per].reshape(1, per), "top": top, "ref": ref}


def share_pages(state: dict, row: torch.Tensor, count) -> dict:
    """Add a reference to the first ``count`` entries of ``row`` (a new
    sequence aliasing an existing prefix, read-only from now on)."""
    held = torch.arange(row.shape[0], device=row.device) < count
    return {"free": state["free"], "top": state["top"],
            "ref": _add_refs(state["ref"], row, held, 1)}


# ---------------------------------------------------------------------------
# cache-level glue: the allocator owns page_table / seq_lens / alloc_held
# ---------------------------------------------------------------------------
def attach_allocator(cache: dict, n_pages: int) -> dict:
    """Put a fresh allocator's state into a paged cache dict (called by
    ``init_cache`` for ``alloc="dynamic"``)."""
    dev = cache["page_table"].device
    state = init_allocator(n_pages, device=dev)
    cache = store_allocator(cache, state)
    cache["alloc_held"] = torch.zeros((cache["page_table"].shape[0],),
                                      dtype=torch.int32, device=dev)
    return cache


def allocator_state(cache: dict) -> dict:
    return {"free": cache["alloc_free"], "top": cache["alloc_top"],
            "ref": cache["alloc_ref"]}


def store_allocator(cache: dict, state: dict) -> dict:
    cache["alloc_free"], cache["alloc_top"], cache["alloc_ref"] = \
        state["free"], state["top"], state["ref"]
    return cache


def require_allocator(cache: dict, what: str) -> None:
    """Raise unless ``cache`` carries the allocator, whose reserved
    scratch page is the only safe sink for a masked write."""
    if "alloc_free" not in cache:
        raise ValueError(
            f"{what} sends masked writes to page {SCRATCH_PAGE}, which only "
            "an allocator reserves: build the cache with "
            "CacheConfig(layout='paged', alloc='dynamic') (on a static "
            f"table page {SCRATCH_PAGE} holds sequence 0's first tokens)")


def _page_size(cache: dict) -> int:
    return cache["k_pages"].shape[2]


def pool_occupancy(cache: dict) -> tuple[int, int]:
    """(pages in use, pool size); the scratch page counts as used.  Reads
    the stack pointer back to the host."""
    n = cache["alloc_free"].numel()
    return n - int(cache["alloc_top"].sum()), n


def admit_sequence(cache: dict, slot: int, n_tokens: int):
    """Allocate pages for a sequence of up to ``n_tokens`` tokens into
    batch row ``slot``.  Returns ``(cache, ok)``; on success the row's
    table entries are the fresh pages (tail: scratch), its length 0 and
    ``alloc_held`` the page count; on failure the cache is unchanged."""
    width = cache["page_table"].shape[1]
    need = ceil_div(int(n_tokens), _page_size(cache))
    if need > width:
        raise ValueError(f"{n_tokens} tokens need {need} pages, the table "
                         f"holds {width}")
    state, row, ok = alloc_pages(allocator_state(cache), need, width)
    store_allocator(cache, state)
    pt, lens, held = (cache["page_table"], cache["seq_lens"],
                      cache["alloc_held"])
    pt[slot] = torch.where(ok, row, pt[slot])
    lens[slot] = torch.where(ok, 0, lens[slot])
    held[slot] = torch.where(ok, need, held[slot])
    return cache, ok


def free_sequence(cache: dict, slot: int) -> dict:
    """Retire row ``slot``: drop its page references (recycling those that
    reach zero), point the row at scratch, zero its length."""
    pt = cache["page_table"]
    state = free_pages(allocator_state(cache), pt[slot],
                       cache["alloc_held"][slot])
    store_allocator(cache, state)
    pt[slot] = SCRATCH_PAGE
    cache["seq_lens"][slot] = 0
    cache["alloc_held"][slot] = 0
    return cache


def fork_sequence(cache: dict, parent: int, child: int, prefix_len: int,
                  n_tokens: int, *, copy: bool = False):
    """Admit row ``child`` sharing the first ``prefix_len`` committed tokens
    of row ``parent`` (capacity ``n_tokens`` in all).

    The ``prefix_len // page_size`` full prefix pages are aliased into the
    child's row; a partly filled boundary page is copied into a private
    child page (every ``PAGE_STATE_KEYS`` array: scale rows travel with
    their int8 pages), and the rest of the capacity gets fresh pages.
    ``copy=True`` copies the full pages too (no aliasing: the disjoint
    twin the sharing tests compare against).  The child wakes with
    ``seq_lens = prefix_len``.  Returns ``(cache, ok)``.
    """
    page = _page_size(cache)
    pt = cache["page_table"]
    width = pt.shape[1]
    prefix_len = int(prefix_len)
    full = prefix_len // page if not copy else 0
    copied = ceil_div(prefix_len, page) - full     # boundary (or all) pages
    total = ceil_div(int(n_tokens), page)
    if not (prefix_len <= n_tokens and total <= width):
        raise ValueError(f"fork of {prefix_len} of {n_tokens} tokens into "
                         f"a table of {width} pages")
    state, prow, ok = alloc_pages(allocator_state(cache), total - full,
                                  width)
    if not bool(ok):
        return store_allocator(cache, state), ok
    state = share_pages(state, pt[parent], full)
    store_allocator(cache, state)
    j = torch.arange(width, device=pt.device)
    row = torch.where(j < full, pt[parent],
                      torch.where(j < total,
                                  prow[(j - full).clamp(0, width - 1)],
                                  SCRATCH_PAGE))
    # copy-on-write before any child write can land in the parent's page
    src = pt[parent, full:full + copied].long()
    dst = row[full:full + copied].long()
    for key in PAGE_STATE_KEYS:
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    pt[child] = row
    cache["seq_lens"][child] = prefix_len
    cache["alloc_held"][child] = total
    return cache, ok

