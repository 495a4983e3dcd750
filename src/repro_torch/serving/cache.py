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
                    of sequence b; distinct sequences own disjoint pages
  seq_lens          (B,) int32 — tokens committed per sequence

Token position ``p`` of sequence ``b`` lives at
``(page_table[b, p // page_size], p % page_size)``; only the first
``seq_lens[b]`` positions hold committed data (later slots may hold
prefill padding, masked until decode overwrites it).  The serving engine
and ``models/attention.py`` write new keys and values into these tensors
in place.

Not ported yet: the free-list allocator (``alloc="dynamic"``,
``pool_pages``; ROADMAP queue 1, item 9) and mesh sharding (item 13).
SSM and hybrid state come with item 12, and until then ``init_cache``
refuses their configs as ``init_model`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention.decode import ceil_div
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported

DEFAULT_PAGE_SIZE = 64

# every per-page array of the paged layout: whatever moves physical pages
# moves these together (scale rows travel with their int8 pages)
PAGE_STATE_KEYS = ("k_pages", "v_pages", "k_scales", "v_scales")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Decode-cache construction knobs.

      layout:    ``"dense"`` | ``"paged"``.
      page_size: tokens per KV page (paged only).
      alloc:     static page tables, ``"contiguous"`` or ``"striped"``
                 (``default_page_table``).
      kv_quant:  ``"none"`` | ``"int8"`` (int8 pools + f32 scale rows;
                 paged only).
    """
    layout: str = "dense"
    page_size: int = DEFAULT_PAGE_SIZE
    alloc: str = "contiguous"
    kv_quant: str = "none"


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
    raise ValueError(f"unknown page allocation {alloc!r} (the port has "
                     "'contiguous' and 'striped'; 'dynamic' comes with the "
                     "allocator, ROADMAP queue 1, item 9)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, config: CacheConfig | None = None, *,
               device="cuda") -> dict:
    """Zero-initialised decode cache for ``batch`` sequences of up to
    ``max_len`` tokens, on ``device``.

    ``dtype`` is the KV storage dtype (the int8 layout stores int8 values
    and f32 scales instead).  ``config`` selects the layout (default: the
    dense one).  Returns a dict of tensors, shapes in the module
    docstring; the paged dict also carries ``page_table`` and
    ``seq_lens``.
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
    if config.layout == "dense":
        shape = (n_layers, batch, max_len, kvh, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    page = config.page_size
    max_pages = ceil_div(max_len, page)
    table = default_page_table(batch, max_pages, config.alloc)
    n_pages = batch * max_pages
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
    cache["page_table"] = table.to(dev)
    cache["seq_lens"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache
