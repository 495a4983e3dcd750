"""Decode-state (KV) cache: ``CacheConfig`` and construction.

Two layouts behind one ``init_cache``, as in the JAX package:

**dense** — one rectangular buffer per tensor:
  k/v  (L, B, S_max, KVH, hd)

**paged** — fixed-size KV pages in a pool plus per-sequence page tables:
  k_pages/v_pages   (L, n_pages, page_size, KVH, hd)
  k_scales/v_scales (L, n_pages, page_size, KVH) f32 — ``kv_quant="int8"``
                    only: per-(page-slot, kv-head) absmax scales of the
                    int8 pools, addressed through the same page table
  page_table        (B, max_pages) int32 — physical page of logical page j
                    of sequence b; distinct sequences never write the same
                    page (a read-only shared prefix page may appear in
                    several rows, its references counted by the allocator)
  seq_lens          (B,) int32 — tokens committed per sequence
  alloc_*           (``alloc="dynamic"`` only) the free-list allocator's
                    state — see ``serving/allocator.py``

Token position ``p`` of sequence ``b`` lives at
``(page_table[b, p // page_size], p % page_size)``; only the first
``seq_lens[b]`` positions hold committed data (later slots may hold
prefill padding, masked until decode overwrites it).  The serving engine
and ``models/attention.py`` write new keys and values into these tensors
in place.

**SSM / hybrid** — per-slot recurrent state, dense (O(1) in context
length, nothing to page):
  ssm_h      (L, B, H, P, N) f32 — each Mamba layer's SSD state
  conv_x     (L, B, k-1, d_inner) f32, conv_B / conv_C (L, B, k-1, N)
             f32 — the conv windows' tails
  shared_k/v (sites, B, S_max, KVH, hd) — hybrid only: the shared
             attention block's KV, one row per application site
  seq_lens   (B,) int32 — tokens committed per sequence
The state stays f32 whatever the KV dtype: the recurrence and the conv
windows accumulate across steps.

The vision family's cache is its text decoder's, like any dense model's.
An encoder-decoder keeps its decoder's self-attention KV only, over its
``n_layers`` decoder layers, dense or paged: its cross-attention reads
the encoder's output (``memory``), which the caller keeps and passes to
every step, and recomputes K and V from it, so nothing of it is cached.

Not ported yet: mesh sharding and per-shard free lists (ROADMAP queue
1, item 13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention.decode import ceil_div
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (check_supported,
                                            is_ssm_family, shared_sites)

DEFAULT_PAGE_SIZE = 64

# every per-page array of the paged layout: whatever moves physical pages
# moves these together (scale rows travel with their int8 pages)
PAGE_STATE_KEYS = ("k_pages", "v_pages", "k_scales", "v_scales")

# the dynamic allocator's reserved sink page: never allocated, so masked
# writes may land there (on a static table it is sequence 0's first page)
SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Decode-cache construction knobs.

      layout:    ``"dense"`` | ``"paged"``.
      page_size: tokens per KV page (paged only).
      alloc:     static page tables, ``"contiguous"`` or ``"striped"``
                 (``default_page_table``), or ``"dynamic"``: the embedded
                 free-list allocator hands pages out at admission.
      pool_pages: physical pool size (paged; default ``batch *
                 ceil(max_len / page_size)``; below that only with
                 ``alloc="dynamic"``).
      kv_quant:  ``"none"`` | ``"int8"`` (int8 pools + f32 scale rows;
                 paged only).
    """
    layout: str = "dense"
    page_size: int = DEFAULT_PAGE_SIZE
    alloc: str = "contiguous"
    pool_pages: int | None = None
    kv_quant: str = "none"


def n_shared_sites(cfg: ModelConfig) -> int:
    """Application sites of the hybrid family's shared block (0 outside
    it): ``n_layers // shared_attn_every``."""
    return sum(shared_sites(cfg))


def default_page_table(batch: int, max_pages: int,
                       alloc: str = "contiguous") -> torch.Tensor:
    """(B, max_pages) int32 page table over a ``batch * max_pages`` pool.

      * ``"contiguous"`` — sequence ``b`` owns pages ``[b*max_pages,
        (b+1)*max_pages)`` in order.
      * ``"striped"`` — logical page ``j`` of sequence ``b`` is physical
        page ``j * batch + b``: one sequence's pages are scattered over
        the pool.

    Both give the same attention: the kernel addresses pages only through
    the table.
    """
    b = torch.arange(batch, dtype=torch.int32)[:, None]
    j = torch.arange(max_pages, dtype=torch.int32)[None, :]
    if alloc == "contiguous":
        return b * max_pages + j
    if alloc == "striped":
        return j * batch + b
    raise ValueError(f"unknown page allocation {alloc!r} (static tables "
                     "are 'contiguous' or 'striped'; 'dynamic' tables come "
                     "from serving/allocator.py)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, config: CacheConfig | None = None, *,
               device="cuda") -> dict:
    """Zero-initialised decode cache for ``batch`` sequences of up to
    ``max_len`` tokens, on ``device``.

    ``dtype`` is the KV storage dtype (the int8 layout stores int8 values
    and f32 scales instead; SSM state is f32 whatever it is).  ``config``
    selects the layout (default: the dense one; the SSM and hybrid
    families take only that).  Returns a dict of tensors, shapes in the
    module docstring; the paged dict also carries ``page_table`` and
    ``seq_lens``, and under ``alloc="dynamic"`` the allocator's state,
    with every table row pointing at the reserved scratch page.
    """
    config = config or CacheConfig()
    if config.layout not in ("dense", "paged"):
        raise ValueError(f"unknown cache layout {config.layout!r}")
    if config.kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown kv_quant {config.kv_quant!r} "
                         "(expected 'none' or 'int8')")
    if config.kv_quant != "none" and config.layout != "paged":
        raise ValueError(
            f"kv_quant={config.kv_quant!r} requires layout='paged': the "
            "scale rows ride the page table")
    check_supported(cfg)
    dev = resolve_device(device)
    kvh, hd, n_layers = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    if is_ssm_family(cfg):
        if config.layout == "paged":
            raise ValueError(
                "the paged layout applies to attention-family KV caches; "
                f"family {cfg.family!r} keeps its O(1) SSM state dense")
        k = cfg.ssm_conv - 1
        f32 = dict(dtype=torch.float32, device=dev)
        cache = {
            "ssm_h": torch.zeros((n_layers, batch, cfg.ssm_n_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state), **f32),
            "conv_x": torch.zeros((n_layers, batch, k, cfg.d_inner), **f32),
            "conv_B": torch.zeros((n_layers, batch, k, cfg.ssm_state), **f32),
            "conv_C": torch.zeros((n_layers, batch, k, cfg.ssm_state), **f32),
        }
        sites = n_shared_sites(cfg)
        if sites:
            shape = (sites, batch, max_len, kvh, hd)
            cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["seq_lens"] = torch.zeros((batch,), dtype=torch.int32,
                                        device=dev)
        return cache
    if config.layout == "dense":
        shape = (n_layers, batch, max_len, kvh, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    page = config.page_size
    max_pages = ceil_div(max_len, page)
    n_pages = (config.pool_pages if config.pool_pages is not None
               else batch * max_pages)
    dynamic = config.alloc == "dynamic"
    if not dynamic:
        table = default_page_table(batch, max_pages, config.alloc)
        if n_pages < batch * max_pages:
            raise ValueError(
                f"static page tables need batch*max_pages = "
                f"{batch * max_pages} pages; pool has {n_pages} (use "
                "alloc='dynamic' to oversubscribe)")
    quant = config.kv_quant == "int8"
    pool = (n_layers, n_pages, page, kvh, hd)
    pool_dtype = torch.int8 if quant else dtype
    cache = {"k_pages": torch.zeros(pool, dtype=pool_dtype, device=dev),
             "v_pages": torch.zeros(pool, dtype=pool_dtype, device=dev)}
    if quant:
        # zero scales dequantize the zero pool to exact zeros
        cache["k_scales"] = torch.zeros(pool[:-1], dtype=torch.float32,
                                        device=dev)
        cache["v_scales"] = torch.zeros(pool[:-1], dtype=torch.float32,
                                        device=dev)
    cache["seq_lens"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if dynamic:
        from repro_torch.serving.allocator import attach_allocator
        # every row starts unallocated, pointing at the reserved scratch page
        cache["page_table"] = torch.full((batch, max_pages), SCRATCH_PAGE,
                                         dtype=torch.int32, device=dev)
        return attach_allocator(cache, n_pages)
    cache["page_table"] = table.to(dev)
    return cache


def page_slots(page_table: torch.Tensor, tok_pos: torch.Tensor,
               keep: torch.Tensor, page: int):
    """(physical page, slot within it) of each logical token position
    ``tok_pos`` (B, S): a masked write's indices.  Positions outside
    ``keep`` (B, S) bool, and those past the table's reach, go to
    ``(SCRATCH_PAGE, 0)``; the logical page is clipped into the table
    before it is looked up, so no index faults."""
    width = page_table.shape[1]
    keep = keep & (tok_pos < width * page)
    pidx = torch.gather(page_table, 1,
                        (tok_pos // page).clamp(0, width - 1)).long()
    return (torch.where(keep, pidx, SCRATCH_PAGE),
            torch.where(keep, tok_pos % page, 0))


def invalidate_token_rows(cache: dict, tok_pos: torch.Tensor,
                          inv: torch.Tensor) -> dict:
    """Zero, in place, the page-state rows holding the selected token
    positions: speculative rollback's page-state half.

    ``tok_pos`` (B, S) logical token positions per sequence; ``inv``
    (B, S) bool selects which to zero, in every ``PAGE_STATE_KEYS`` array
    (an int8 pool's scale rows with its values), so nothing that later
    aliases the page (a fork, a shared prefix) sees rejected draft state.
    Deselected entries and positions past the table's reach are sent to
    the allocator's reserved scratch page, so the cache must carry the
    allocator: on a static table page 0 is sequence 0's first page, and
    the redirected writes would zero its committed rows.
    """
    from repro_torch.serving.allocator import require_allocator
    require_allocator(cache, "invalidate_token_rows")
    pidx, slot = page_slots(cache["page_table"], tok_pos.long(), inv,
                            cache["k_pages"].shape[2])
    for key in PAGE_STATE_KEYS:
        if key in cache:
            cache[key][:, pidx, slot] = 0
    return cache


def page_nbytes(cache: dict) -> int:
    """Device bytes one physical page occupies across all layers: K and V
    values plus, in the int8 layout, their scale rows."""
    n_pages = cache["k_pages"].shape[1]
    total = sum(cache[k].numel() * cache[k].element_size()
                for k in PAGE_STATE_KEYS if k in cache)
    return total // n_pages
