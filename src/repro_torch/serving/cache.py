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

**Sharding** (``docs/DESIGN.md`` §3): under ``CacheConfig(mesh=...)``
(a ``launch.mesh.Mesh``) each rank builds its own part of the pools, the
**local slab**.  KV heads go to the ``model`` axis when they divide its
extent (``heads``: tensor-parallel decode, pools ``(L, P, page, K/m,
hd)``); otherwise the paged pool's page dim does (``pages``: split-KV
decode over ``(L, P/m, page, K, hd)``, rank ``r`` holding the global pages
``[r·P/m, (r+1)·P/m)``, with per-shard free lists), and the int8 scale
pools follow their pages.  ``cache_logical_axes`` gives each array's
logical axes and ``cache_shardings`` resolves them to placements under
``SERVING_RULES``.  The page table, lengths and allocator state are whole
on every rank (the JAX package partitions the allocator's arrays with the
pool; here each rank keeps all of it, a few integers a page, and every
rank runs the same operations on it).  The cache also carries its
resolved policy, ``kv_shard`` (the string ``"heads"`` or ``"pages"``;
absent on a cache built without a mesh of more than one rank): the
attention, the allocator and ``validate_decode_cache`` branch on it and
never infer it from a slab's shape.  A dense cache splits by KV heads
likewise, or else by sequence (the policy is still called ``"pages"``):
``k`` / ``v`` ``(L, B, S_max/m, K, hd)``, rank ``r`` holding the positions
``[r·S_max/m, (r+1)·S_max/m)`` (the JAX package's ``kv_seq``; ``max_len``
is rounded up to a multiple of ``m``).  The SSM and hybrid families' slot
state splits as the JAX package's ``cache_logical_axes`` place it:
``ssm_h`` by SSM heads (L, B, H/m, P, N), ``conv_x`` by their channels
(L, B, k-1, d_inner/m), ``conv_B`` / ``conv_C`` and ``seq_lens`` whole,
a hybrid's ``shared_k`` / ``shared_v`` as a dense attention cache, by KV
heads or by sequence.  SSM heads that do not divide the ``model`` extent
raise.
"""
from __future__ import annotations

import dataclasses

import torch

from typing import Any

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention.decode import ceil_div
from repro_torch.launch.sharding import (DEFAULT_LOGICAL_RULES, on_axis,
                                         tree_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import check_head_split
from repro_torch.models.transformer import (check_supported,
                                            is_ssm_family, shared_sites)

DEFAULT_PAGE_SIZE = 64

# every per-page array of the paged layout: whatever moves physical pages
# moves these together (scale rows travel with their int8 pages)
PAGE_STATE_KEYS = ("k_pages", "v_pages", "k_scales", "v_scales")

# the dynamic allocator's reserved sink page: never allocated, so masked
# writes may land there (on a static table it is sequence 0's first page)
SCRATCH_PAGE = 0

# serving puts the paged pool's page dim on `model` alone (the generic
# kv_pages chain also offers data / pod): the per-shard allocator and the
# split-KV decode need one known axis to size their shards and reduce over
SERVING_RULES: dict[str, tuple] = dict(DEFAULT_LOGICAL_RULES,
                                       kv_pages=("model",))


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

    Sharding knobs:
      mesh:      a ``launch.mesh.Mesh`` (or None): ``init_cache`` builds
                 this rank's slab, and the model's forward runs the
                 tensor-parallel or split-KV decode.
      kv_shard:  ``"auto"`` — KV heads to ``model`` when they divide it,
                 else the page dim; ``"heads"`` / ``"pages"`` (alias
                 ``"seq"``) force a policy.
      pool_shards: the allocator's shard count without a mesh (to test
                 the per-shard free lists); defaults to the ``model``
                 extent under the pages policy, else 1.
    """
    layout: str = "dense"
    page_size: int = DEFAULT_PAGE_SIZE
    alloc: str = "contiguous"
    pool_pages: int | None = None
    kv_quant: str = "none"
    mesh: Any = None
    kv_shard: str = "auto"
    pool_shards: int | None = None

    def model_size(self) -> int:
        """Extent of the mesh's ``model`` axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get("model", 1))

    def resolved_kv_shard(self, n_kv_heads: int) -> str | None:
        """``"heads"`` | ``"pages"`` | None: the KV partitioning the decode
        runs with (None: unsharded)."""
        m = self.model_size()
        if m <= 1:
            return None
        if self.kv_shard == "heads":
            if n_kv_heads % m:
                raise ValueError(
                    f"kv_shard='heads' needs n_kv_heads ({n_kv_heads}) "
                    f"divisible by the model axis ({m})")
            return "heads"
        if self.kv_shard in ("seq", "pages"):
            return "pages"
        if self.kv_shard != "auto":
            raise ValueError(f"unknown kv_shard {self.kv_shard!r}")
        return "heads" if n_kv_heads % m == 0 else "pages"

    def shards(self, n_kv_heads: int) -> int:
        """The pool's (and allocator's) shard count: the ``model`` extent
        when the page dim is split, else 1 (a heads-split pool keeps every
        page on every rank, so its free list stays flat)."""
        if self.pool_shards is not None:
            return self.pool_shards
        if (self.layout == "paged"
                and self.resolved_kv_shard(n_kv_heads) == "pages"):
            return self.model_size()
        return 1

    def logical_axes(self, cfg: ModelConfig) -> dict:
        return cache_logical_axes(
            cfg, self.kv_shard, layout=self.layout,
            dynamic=(self.alloc == "dynamic"), kv_quant=self.kv_quant,
            model_size=self.model_size() if self.mesh is not None else None)


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
    with every table row pointing at the reserved scratch page.  Under
    ``config.mesh`` the pools are this rank's slab (module docstring); the
    pool's global page count, or a dense cache's ``max_len`` split by
    sequence, is rounded up to a multiple of its shard count.
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
    kvh = cfg.n_kv_heads
    if config.layout == "dense" and config.resolved_kv_shard(kvh) == "pages":
        # split by sequence: every rank holds an equal run of positions
        max_len = ceil_div(max_len, config.model_size()) * config.model_size()
    if is_ssm_family(cfg):
        if config.layout == "paged":
            raise ValueError(
                "the paged layout applies to attention-family KV caches; "
                f"family {cfg.family!r} keeps its O(1) SSM state dense")
        check_head_split(cfg.ssm_n_heads, config.model_size())
        shapes, dtypes = _slot_shapes(cfg, batch, max_len, dtype)
    else:
        shapes, dtypes = _kv_shapes(cfg, batch, max_len, dtype, config)
    if config.mesh is not None:
        shapes = local_shapes(shapes, cache_shardings(cfg, shapes, config),
                              config.mesh)
    cache = {key: torch.zeros(shape, dtype=dtypes[key], device=dev)
             for key, shape in shapes.items()}
    if config.model_size() > 1:
        # the slot state splits by SSM heads (a pure SSM model has no KV
        # heads: "heads"), a hybrid's shared KV by its KV heads
        cache["kv_shard"] = config.resolved_kv_shard(kvh)
    if config.layout == "dense":
        return cache
    page = config.page_size
    max_pages = ceil_div(max_len, page)
    if config.alloc == "dynamic":
        from repro_torch.serving.allocator import attach_allocator
        # every row starts unallocated, pointing at the reserved scratch page
        cache["page_table"].fill_(SCRATCH_PAGE)
        return attach_allocator(cache, pool_pages(cfg, batch, max_len,
                                                  config),
                                config.shards(kvh))
    cache["page_table"] = default_page_table(batch, max_pages,
                                             config.alloc).to(dev)
    return cache


def pool_pages(cfg: ModelConfig, batch: int, max_len: int,
               config: CacheConfig) -> int:
    """Global pages of the paged pool: ``config.pool_pages`` (default
    ``batch * ceil(max_len / page_size)``), rounded up to a multiple of
    the pool's shard count so that every shard owns an equal slab."""
    n = (config.pool_pages if config.pool_pages is not None
         else batch * ceil_div(max_len, config.page_size))
    shards = config.shards(cfg.n_kv_heads)
    return ceil_div(n, shards) * shards


def _slot_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype):
    """({key: global shape}, {key: dtype}) of an SSM or hybrid family's
    slot state: f32 recurrent state and conv tails, the hybrid's shared
    KV in ``dtype``, int32 lengths."""
    k, n_layers = cfg.ssm_conv - 1, cfg.n_layers
    f32 = torch.float32
    shapes = {"ssm_h": (n_layers, batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                        cfg.ssm_state),
              "conv_x": (n_layers, batch, k, cfg.d_inner),
              "conv_B": (n_layers, batch, k, cfg.ssm_state),
              "conv_C": (n_layers, batch, k, cfg.ssm_state)}
    dtypes = dict.fromkeys(shapes, f32)
    sites = n_shared_sites(cfg)
    if sites:
        shape = (sites, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        shapes.update(shared_k=shape, shared_v=shape)
        dtypes.update(shared_k=dtype, shared_v=dtype)
    shapes["seq_lens"] = (batch,)
    dtypes["seq_lens"] = torch.int32
    return shapes, dtypes


def _kv_shapes(cfg: ModelConfig, batch: int, max_len: int, dtype,
               config: CacheConfig):
    """({key: global shape}, {key: dtype}) of an attention family's dense
    or paged cache (the allocator's arrays come from ``attach_allocator``)."""
    kvh, hd, n_layers = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    i32 = torch.int32
    if config.layout == "dense":
        shape = (n_layers, batch, max_len, kvh, hd)
        return {"k": shape, "v": shape}, {"k": dtype, "v": dtype}
    page = config.page_size
    max_pages = ceil_div(max_len, page)
    n_pages = pool_pages(cfg, batch, max_len, config)
    if config.alloc != "dynamic" and n_pages < batch * max_pages:
        raise ValueError(
            f"static page tables need batch*max_pages = "
            f"{batch * max_pages} pages; pool has {n_pages} (use "
            "alloc='dynamic' to oversubscribe)")
    quant = config.kv_quant == "int8"
    pool = (n_layers, n_pages, page, kvh, hd)
    pool_dtype = torch.int8 if quant else dtype
    shapes = {"k_pages": pool, "v_pages": pool}
    dtypes = {"k_pages": pool_dtype, "v_pages": pool_dtype}
    if quant:
        # zero scales dequantize the zero pool to exact zeros
        shapes.update(k_scales=pool[:-1], v_scales=pool[:-1])
        dtypes.update(k_scales=torch.float32, v_scales=torch.float32)
    shapes.update(seq_lens=(batch,), page_table=(batch, max_pages))
    dtypes.update(seq_lens=i32, page_table=i32)
    return shapes, dtypes


# the arrays a rank holds only its part of; the others are whole everywhere
SLAB_KEYS = (("k", "v") + PAGE_STATE_KEYS
             + ("ssm_h", "conv_x", "shared_k", "shared_v"))


def local_shapes(shapes: dict, placements: dict, mesh) -> dict:
    """Each rank's shapes: a ``SLAB_KEYS`` array's dims placed on ``model``
    divided by the mesh's extent; every other array whole."""
    out = {}
    for key, shape in shapes.items():
        spec = placements.get(key, (None,) * len(shape))
        if key in SLAB_KEYS:
            shape = tuple(n // mesh.size if on_axis(p) else n
                          for n, p in zip(shape, spec))
        out[key] = tuple(shape)
    return out


def cache_shardings(cfg: ModelConfig, shapes: dict,
                    config: CacheConfig) -> dict:
    """The placement of each cache array (one entry per dim: None or mesh
    axes) for ``shapes`` ({key: global shape}, or a cache of global
    tensors) built with ``config`` (which needs a mesh), under
    ``SERVING_RULES``: the JAX package's ``cache_shardings`` as plain
    tuples.  ``init_cache`` gives each rank its part of the
    ``SLAB_KEYS`` arrays by them."""
    if config.mesh is None:
        raise ValueError("cache_shardings needs CacheConfig(mesh=...)")
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in shapes.items()}
    axes = config.logical_axes(cfg)
    return tree_specs({k: shapes[k] for k in shapes if k in axes}, axes,
                      config.mesh, SERVING_RULES)


def cache_logical_axes(cfg: ModelConfig, kv_shard: str = "auto", *,
                       layout: str = "dense", dynamic: bool = False,
                       kv_quant: str = "none",
                       model_size: int | None = None) -> dict:
    """Logical axes of each cache array (``docs/DESIGN.md`` §3).

    ``kv_shard``: ``auto | heads | seq | pages``; ``seq`` / ``pages`` put
    the dense cache's sequence dim, or the paged pool's page dim, on
    ``model``.  ``auto`` resolves against ``model_size`` when given, else
    the 16-way reference mesh.  ``dynamic`` adds the allocator's arrays
    (their shard dim takes ``kv_pages``); ``kv_quant="int8"`` the scale
    pools, placed as their pages without the trailing head dim.
    """
    axes: dict = {}
    if cfg.family in ("ssm", "hybrid"):
        axes["ssm_h"] = (None, "batch", "ssm_heads", None, None)
        axes["conv_x"] = (None, "batch", None, "ssm_inner")
        axes["conv_B"] = (None, "batch", None, None)
        axes["conv_C"] = (None, "batch", None, None)
        axes["seq_lens"] = ("batch",)
        if n_shared_sites(cfg):
            kv = _kv_axes(cfg, kv_shard, model_size)
            axes["shared_k"] = kv
            axes["shared_v"] = kv
    elif layout == "paged":
        kv = _kv_axes(cfg, kv_shard, model_size)
        # (L, P, page, KVH, hd): the pool's page dim takes the kv_seq split
        paged = (None, "kv_pages" if kv[2] == "kv_seq" else None,
                 None, kv[3], None)
        axes["k_pages"] = paged
        axes["v_pages"] = paged
        if kv_quant == "int8":
            axes["k_scales"] = paged[:-1]          # (L, P, page, KVH)
            axes["v_scales"] = paged[:-1]
        axes["page_table"] = ("batch", None)
        axes["seq_lens"] = ("batch",)
        if dynamic:
            # (S, P/S) / (S,) / (S, P/S) / (B,)
            axes["alloc_free"] = ("kv_pages", None)
            axes["alloc_top"] = ("kv_pages",)
            axes["alloc_ref"] = ("kv_pages", None)
            axes["alloc_held"] = ("batch",)
    else:
        kv = _kv_axes(cfg, kv_shard, model_size)
        axes["k"] = kv
        axes["v"] = kv
    return axes


def _kv_axes(cfg: ModelConfig, kv_shard: str,
             model_size: int | None = None) -> tuple:
    # (L, B, S, KVH, hd)
    if kv_shard == "heads":
        return (None, "batch", None, "kv_heads", None)
    if kv_shard in ("seq", "pages"):
        return (None, "batch", "kv_seq", None, None)
    # auto: heads when they divide the model axis (the 16-way reference
    # mesh when no extent is given), else the seq / pages split
    if cfg.n_kv_heads % (model_size or 16) == 0:
        return (None, "batch", None, "kv_heads", None)
    return (None, "batch", "kv_seq", None, None)


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
