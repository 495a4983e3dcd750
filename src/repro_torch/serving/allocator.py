"""Dynamic page allocator and prefix-sharing tables for the paged KV cache.

The kernel addresses KV only through the page table, so physical
placement is free: instead of a static rectangle of pages per sequence, a
free-list allocator hands pages out at admission and takes them back at
retirement, so a pool can serve an unbounded stream of requests
(``serving/scheduler.py``), and two sequences with a common prompt prefix
can share the prefix's pages.

The state is small int32 tensors on the cache's device, kept in the cache
dict as ``alloc_free`` / ``alloc_top`` / ``alloc_ref`` plus ``alloc_held``
(B,) — how many leading ``page_table`` entries each row references.  The
pool may be split ``shards`` ways (the ``pages`` policy of a serving mesh,
``docs/DESIGN.md`` §3): shard ``s`` owns the global page ids
``[s·P/S, (s+1)·P/S)`` and keeps its own free stack, stack pointer and
refcount row:

  free stack   (S, P/S) int32  ``free[s, :top[s]]`` are free global ids
                               owned by shard ``s``
  top          (S,)     int32  free pages per shard (stack pointers)
  refcounts    (S, P/S) int32  live references; global page ``p`` lives
                               at ``(p // (P/S), p % (P/S))`` (0 = free)

Allocation stripes a request's pages round-robin over the shards (page
``j`` from shard ``j mod S``), and admission is taken on the global
minimum of per-shard headroom: a request is admitted only if every shard
can cover its share, so a pool whose total free count would cover it is
still refused when one shard is too full, and the refusal leaves the
state as it was.  ``shards=1`` is the flat free list, bit for bit.  Under
a mesh every rank keeps the whole state (a few integers a page) and runs
the same operations on it, so the ranks agree on every page id; only the
pages themselves are split (``serving/cache.py``).

``alloc_pages`` / ``free_pages`` / ``share_pages`` are masked scatters on
that state, as in the JAX package, so they read nothing back to the host;
the cache-level helpers (``admit_sequence``, ``fork_sequence``, ...)
return ``ok`` as a 0-d bool tensor, and the scheduler branches on it (a
read of one value).

**Reserved scratch page** — page 0 (shard 0's first) is never allocated
(its refcount is pinned at init).  Idle rows and the unallocated tail of
every table row point at it, so their masked writes land somewhere
harmless.  It keeps shard 0 one page short of the others.

**Prefix sharing** — ``fork_sequence`` builds a child row whose first
``prefix_len // page_size`` entries alias the parent's pages (refcount +
1, read-only from then on); the partially filled boundary page is copied
into a private child page at fork time, in every ``PAGE_STATE_KEYS``
array, since the child's first write lands mid-page (across ranks when the
two pages live on different shards of a mesh).  So writes only ever
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
           "pool_occupancy", "shard_occupancy", "can_admit",
           "admit_sequence", "free_sequence", "fork_sequence"]

_RESERVED = 1             # pages [0, _RESERVED) are pinned at init

ALLOC_KEYS = ("alloc_free", "alloc_top", "alloc_ref", "alloc_held")


# ---------------------------------------------------------------------------
# free-list operations on the state {"free", "top", "ref"}
# ---------------------------------------------------------------------------
def init_allocator(n_pages: int, shards: int = 1, *, device="cpu") -> dict:
    """Fresh allocator over a pool of ``n_pages`` pages in ``shards``
    shard-local free lists (``shards`` must divide ``n_pages``): each
    shard's free pages stacked ascending (the top of a stack is its
    highest id, so early allocations land at each shard's far end), the
    scratch page pinned, so shard 0 starts one page short."""
    if shards < 1 or n_pages % shards:
        raise ValueError(f"a pool of {n_pages} pages does not split into "
                         f"{shards} shards")
    per = n_pages // shards
    if per <= _RESERVED:
        raise ValueError(f"a shard of {per} pages is all reserved")
    ids = torch.arange(n_pages, dtype=torch.int32,
                       device=device).reshape(shards, per)
    col = torch.arange(per, device=device)[None, :]
    srow = torch.arange(shards, device=device)[:, None]
    # shard 0 drops the scratch page: [1..per-1, pad 0]; the others keep all
    free = torch.where(srow == 0,
                       torch.where(col < per - _RESERVED, ids + _RESERVED,
                                   torch.zeros_like(ids)), ids)
    top = torch.full((shards,), per, dtype=torch.int32, device=device)
    top[0] = per - _RESERVED
    ref = torch.zeros((shards, per), dtype=torch.int32, device=device)
    ref[0, SCRATCH_PAGE] = 1
    return {"free": free, "top": top, "ref": ref}


def _add_refs(ref: torch.Tensor, pages: torch.Tensor, take: torch.Tensor,
              delta: int) -> torch.Tensor:
    """``ref`` (S, P/S) with ``delta`` added at the global ids
    ``pages[take]`` (a global id is its flat index; no host read: untaken
    entries land in a dropped extra slot)."""
    shape, n = ref.shape, ref.numel()
    flat = torch.cat([ref.reshape(-1), ref.new_zeros(1)])
    idx = torch.where(take, pages.long(), n)
    flat = flat.index_add(0, idx, torch.full_like(idx, delta,
                                                  dtype=ref.dtype))
    return flat[:n].reshape(shape)


def _shard_need(n: int, shards: int, device) -> torch.Tensor:
    """(S,) pages shard ``s`` supplies for a round-robin grab of ``n``:
    ``|{j in [0, n) : j mod S == s}|``."""
    s = torch.arange(shards, dtype=torch.int32, device=device)
    return ((int(n) - s + shards - 1) // shards).clamp(min=0)


def can_admit(state: dict, n: int) -> torch.Tensor:
    """0-d bool: can every shard cover its round-robin share of ``n``
    pages right now (the global-min admission rule)?"""
    top = state["top"]
    return (top - _shard_need(n, top.shape[0], top.device)).min() >= 0


def alloc_pages(state: dict, n: int, width: int):
    """Pop ``n`` pages, round-robin over the shards, into a ``(width,)``
    table row of global page ids (entries past ``n`` are scratch).
    Returns ``(state, row, ok)``; when ``ok`` is False (some shard cannot
    cover its share) the state is unchanged and the row all scratch."""
    free, top, ref = state["free"], state["top"], state["ref"]
    shards, per = free.shape
    n = int(n)
    need = _shard_need(n, shards, top.device)
    ok = (top - need).min() >= 0
    j = torch.arange(width, device=top.device)
    sh = j % shards                          # owning shard of slot j
    rank = j // shards                       # earlier slots on that shard
    take = (j < n) & ok
    idx = (top[sh] - 1 - rank).clamp(0, per - 1).long()
    row = torch.where(take, free[sh, idx], SCRATCH_PAGE)
    ref = _add_refs(ref, row, take, 1)
    top = torch.where(ok, top - need, top)
    return {"free": free, "top": top, "ref": ref}, row, ok


def free_pages(state: dict, row: torch.Tensor, count) -> dict:
    """Drop one reference from the first ``count`` entries of ``row``;
    pages whose refcount reaches zero go back on their owning shard's free
    stack."""
    free, top, ref = state["free"], state["top"], state["ref"]
    shards, per = free.shape
    n_pool = shards * per
    held = torch.arange(row.shape[0], device=row.device) < count
    ref = _add_refs(ref, row, held, -1)
    released = held & (ref.reshape(-1)[row.long()] == 0)
    sh = (row // per).long()                 # owning shard of each entry
    # the k-th released page of shard s lands at free[s, top[s] + k]
    belong = sh[:, None] == torch.arange(shards, device=row.device)[None]
    contrib = (released[:, None] & belong).to(torch.int32)       # (w, S)
    rank = torch.gather(torch.cumsum(contrib, 0) - 1, 1, sh[:, None])[:, 0]
    pos = top[sh] + rank
    safe = released & (pos < per)
    flat = torch.cat([free.reshape(-1), free.new_zeros(1)])
    flat[torch.where(safe, sh * per + pos, n_pool)] = row.to(free.dtype)
    top = top + contrib.sum(0).to(top.dtype)
    return {"free": flat[:n_pool].reshape(shards, per), "top": top,
            "ref": ref}


def share_pages(state: dict, row: torch.Tensor, count) -> dict:
    """Add a reference to the first ``count`` entries of ``row`` (a new
    sequence aliasing an existing prefix, read-only from now on)."""
    held = torch.arange(row.shape[0], device=row.device) < count
    return {"free": state["free"], "top": state["top"],
            "ref": _add_refs(state["ref"], row, held, 1)}


# ---------------------------------------------------------------------------
# cache-level glue: the allocator owns page_table / seq_lens / alloc_held
# ---------------------------------------------------------------------------
def attach_allocator(cache: dict, n_pages: int, shards: int = 1) -> dict:
    """Put a fresh allocator's state over ``n_pages`` global pages in
    ``shards`` free lists into a paged cache dict (called by
    ``init_cache`` for ``alloc="dynamic"``)."""
    dev = cache["page_table"].device
    state = init_allocator(n_pages, shards, device=dev)
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
    """(pages in use, pool size) over every shard; the scratch page counts
    as used.  Reads the stack pointers back to the host.  Admission gates
    on the fullest shard (``shard_occupancy``), which this total hides."""
    n = cache["alloc_free"].numel()
    return n - int(cache["alloc_top"].sum()), n


def shard_occupancy(cache: dict) -> tuple[tuple[int, int], ...]:
    """((pages in use, shard size), ...) for each pool shard."""
    per = cache["alloc_free"].shape[1]
    return tuple((per - t, per) for t in cache["alloc_top"].tolist())


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


def _copy_pages(cache: dict, src: torch.Tensor, dst: torch.Tensor,
                mesh=None) -> None:
    """Copy global pages ``src`` onto ``dst`` in every ``PAGE_STATE_KEYS``
    array.  A pool that holds every page (no mesh, or a mesh's ``heads``
    policy) copies locally; a rank's slab of a pool split by ``pages``
    (the cache's ``kv_shard``) gets each source page from the rank that
    owns it (``mesh.all_gather``) and writes only the destinations it
    owns."""
    keys = [key for key in PAGE_STATE_KEYS if key in cache]
    if cache.get("kv_shard") != "pages":
        for key in keys:
            cache[key][:, dst] = cache[key][:, src]
        return
    if mesh is None:
        raise ValueError("copying pages across the shards of a pool split "
                         "by pages needs the cache's mesh")
    per = cache["k_pages"].shape[1]
    lo = mesh.rank * per
    s_loc, d_loc = src - lo, dst - lo
    s_mine = (s_loc >= 0) & (s_loc < per)
    d_mine = (d_loc >= 0) & (d_loc < per)
    pick = torch.arange(src.shape[0], device=src.device)
    for key in keys:
        pool = cache[key]
        mine = s_mine.reshape((1, -1) + (1,) * (pool.dim() - 2))
        part = torch.where(mine, pool[:, s_loc.clamp(0, per - 1)], 0)
        # (ranks, L, n, ...) → each page from its owner: (L, n, ...)
        every = mesh.all_gather(part[None], dim=0)
        data = every.transpose(1, 2)[src // per, pick].transpose(0, 1)
        pool[:, d_loc[d_mine]] = data[:, d_mine]


def fork_sequence(cache: dict, parent: int, child: int, prefix_len: int,
                  n_tokens: int, *, copy: bool = False, mesh=None):
    """Admit row ``child`` sharing the first ``prefix_len`` committed tokens
    of row ``parent`` (capacity ``n_tokens`` in all).

    The ``prefix_len // page_size`` full prefix pages are aliased into the
    child's row; a partly filled boundary page is copied into a private
    child page (every ``PAGE_STATE_KEYS`` array: scale rows travel with
    their int8 pages), and the rest of the capacity gets fresh pages.
    ``copy=True`` copies the full pages too (no aliasing: the disjoint
    twin the sharing tests compare against).  The child wakes with
    ``seq_lens = prefix_len``.  Returns ``(cache, ok)``.  ``mesh``: the
    cache's mesh, which a copy between shards of a split pool goes
    through (``_copy_pages``).
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
    _copy_pages(cache, pt[parent, full:full + copied].long(),
                row[full:full + copied].long(), mesh)
    pt[child] = row
    cache["seq_lens"][child] = prefix_len
    cache["alloc_held"][child] = total
    return cache, ok

