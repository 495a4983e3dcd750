"""Sequence-state registry: the scheduler's contract with a family's decode
state.

Per-sequence state must be claimed at admission, recycled at retirement,
advanced per decode tick and reported for occupancy; ``state_handler``
picks one handler per family.  The port has the attention families'
handler:

  ``paged_kv`` — sequence state is refcounted KV pages; admission, free
                 and fork go to the free-list allocator
                 (``serving/allocator.py``), prefix sharing and
                 speculative rollback are supported.

The SSM and hybrid families' slot handlers (``ssm_slot``, ``hybrid``)
come with those families (ROADMAP queue 1, item 12), and with them the
contract they share with ``PagedKVHandler``.  Handlers are host-side
glue over the cache dict, which they update in place and return.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving import allocator as alloc
from repro_torch.serving.cache import CacheConfig

__all__ = ["PagedKVHandler", "state_handler", "default_serving_config"]


class PagedKVHandler:
    """Attention families: sequence state is refcounted KV pages.

    ``slot`` / ``parent`` / ``child`` are batch-row indices.
    """

    name = "paged_kv"

    def occupancy(self, cache):
        """(used, total, per_shard) pages (one shard)."""
        used, total = alloc.pool_occupancy(cache)
        return used, total, ((used, total),)

    def admit(self, cache, slot, n_tokens):
        """Claim pages for up to ``n_tokens`` tokens in row ``slot``.
        Returns ``(cache, ok)``; on ``ok`` False the cache is unchanged."""
        return alloc.admit_sequence(cache, slot, n_tokens)

    def free(self, cache, slot):
        """Retire row ``slot``, recycling the pages only it held."""
        return alloc.free_sequence(cache, slot)

    def fork(self, cache, parent, child, prefix_len, n_tokens):
        """Admit ``child`` sharing ``parent``'s first ``prefix_len``
        committed tokens; ``(cache, ok)``."""
        return alloc.fork_sequence(cache, parent, child, prefix_len,
                                   n_tokens)

    def advance(self, cache, active):
        """After a tick: idle rows advanced their (zero) lengths inside the
        batched step; pin them back to 0 so an idle row's masked walk
        never grows.  ``active`` is a (B,) bool mask."""
        lens = cache["seq_lens"]
        cache["seq_lens"] = torch.where(active.to(lens.device), lens,
                                        0).to(lens.dtype)
        return cache

    def slot_view(self, cache, b):
        """A batch-1 view of row ``b`` for a per-row prefill: the pools
        are shared, and a prefill writes them in place through the row's
        own table entries."""
        view = dict(cache)
        view["page_table"] = cache["page_table"][b:b + 1]
        view["seq_lens"] = cache["seq_lens"][b:b + 1]
        return view

    def merge_slot(self, cache, view, b):
        """Fold a prefilled ``slot_view`` back into row ``b``."""
        cache["seq_lens"][b] = view["seq_lens"][0]
        return cache

    def draft_fork(self, draft_cache, parent, child):
        """Copy ``parent``'s dense draft-cache row into ``child``."""
        for key in ("k", "v"):
            draft_cache[key][:, child] = draft_cache[key][:, parent]
        return draft_cache


def state_handler(cfg: ModelConfig) -> PagedKVHandler:
    """The registry: family → handler instance."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family's slot-state handler is "
            "not ported yet (ROADMAP queue 1, item 12)")
    return PagedKVHandler()


def default_serving_config(cfg: ModelConfig) -> CacheConfig:
    """The continuous-batching default: dynamic 16-token pages."""
    return CacheConfig(layout="paged", alloc="dynamic", page_size=16)
