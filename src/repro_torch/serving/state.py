"""Sequence-state registry: the scheduler's contract with a family's decode
state.

Per-sequence state must be claimed at admission, recycled at retirement,
advanced per decode tick and reported for occupancy.  ``StateHandler``
names that contract and ``state_handler`` picks one handler per family:

  ``paged_kv`` — attention families (dense and MoE): sequence state is
                 refcounted KV pages; admission, free and fork go to the
                 free-list allocator (``serving/allocator.py``), prefix
                 sharing and speculative rollback are supported.
  ``ssm_slot`` — pure SSM (mamba2): a batch row is the allocation unit.
                 Admission and free zero the row's recurrent state
                 (``SLOT_STATE_KEYS``) and its length; there is no pool,
                 so ``admit`` succeeds while a batch slot is free, and
                 ``capacity`` is None (no positional bound).
  ``hybrid``   — zamba2: ``ssm_slot`` plus the shared attention block's
                 dense KV rows (``shared_k/v``), which bound capacity at
                 their S_max and travel with the slot in its views.
                 Admission does not zero them: ``seq_lens``
                 governs what is attended, and prefill and decode
                 overwrite a position before it becomes visible.

Recurrent state folds every token into one fixed-size state and cannot
rewind a rejected draft, so the slot handlers do not support speculative
decode (the Scheduler then serves plain 1-token decode) or prefix
sharing.  Handlers are host-side glue over the cache dict, which they
update in place and return.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import is_ssm_family
from repro_torch.serving import allocator as alloc
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import cache_capacity

__all__ = ["SLOT_STATE_KEYS", "StateHandler", "PagedKVHandler",
           "SlotStateHandler", "HybridHandler", "state_handler",
           "default_serving_config"]

# the per-slot recurrent state of an SSM family cache: what a slot
# admission resets (a stale conv tail would leak the previous occupant's
# suffix into token 0)
SLOT_STATE_KEYS = ("ssm_h", "conv_x", "conv_B", "conv_C")


class StateHandler:
    """One family's contract over a decode cache's sequence state.

    ``slot`` / ``parent`` / ``child`` are batch-row indices: the batch row
    is the addressing unit; what backs a row (pages, an SSM slot, both) is
    the handler's business.
    """

    name = "base"
    supports_prefix_sharing = False
    # can this family's state roll back a rejected speculative tail?
    supports_speculative = False

    def __init__(self, cfg: ModelConfig, config: CacheConfig | None = None):
        self.cfg = cfg
        self.config = config

    def capacity(self, cache: dict) -> int | None:
        """Max tokens one sequence may reach, or None (no positional
        bound: pure-SSM state is O(1) in context length)."""
        return cache_capacity(cache)

    def occupancy(self, cache: dict):
        """(used, total, per_shard) in the handler's allocation units
        (pages for ``paged_kv``, batch slots for the slot families)."""
        raise NotImplementedError

    def admit(self, cache: dict, slot: int, n_tokens: int):
        """Claim state for up to ``n_tokens`` tokens in row ``slot``.
        Returns ``(cache, ok)``; on ``ok`` False the cache is unchanged."""
        raise NotImplementedError

    def free(self, cache: dict, slot: int) -> dict:
        """Retire row ``slot``, recycling what it held."""
        raise NotImplementedError

    def fork(self, cache: dict, parent: int, child: int, prefix_len: int,
             n_tokens: int):
        """Admit ``child`` sharing ``parent``'s first ``prefix_len``
        committed tokens; ``(cache, ok)``.  Without prefix sharing,
        ``(cache, False)``: the caller admits plainly."""
        return cache, False

    def reset_rows(self, cache: dict, slot: int) -> dict:
        """Zero row ``slot``'s per-sequence state and length."""
        raise NotImplementedError

    def advance(self, cache: dict, active) -> dict:
        """After a tick: idle rows advanced their (zero) lengths inside the
        batched step; pin them back to 0 so an idle row's masked walk
        never grows.  ``active`` is a (B,) bool mask."""
        lens = cache["seq_lens"]
        cache["seq_lens"] = torch.where(
            torch.as_tensor(active, device=lens.device), lens, 0
        ).to(lens.dtype)
        return cache

    def slot_view(self, cache: dict, b: int) -> dict:
        """A batch-1 view of row ``b`` for a per-row prefill: the
        per-sequence tensors are views of row ``b`` (written in place),
        the shared ones ride along whole."""
        raise NotImplementedError

    def merge_slot(self, cache: dict, view: dict, b: int) -> dict:
        """Fold a prefilled ``slot_view`` back into row ``b``: its state
        rows are the cache's, written in place, so only the length."""
        cache["seq_lens"][b] = view["seq_lens"][0]
        return cache

    def draft_free(self, draft_cache: dict, slot: int) -> dict:
        """Retire row ``slot`` of the dense draft cache: nothing to do, the
        target's ``seq_lens`` governs what the draft attends, and the next
        occupant's prefill overwrites the row before a draft step."""
        return draft_cache

    def draft_fork(self, draft_cache: dict, parent: int, child: int) -> dict:
        """Copy ``parent``'s draft-cache row into ``child`` (handlers with
        ``supports_speculative`` and prefix sharing only)."""
        raise NotImplementedError

    def require_scheduler_config(self) -> None:
        """Raise if ``self.config`` cannot back a continuous-batching
        Scheduler for this family."""


class PagedKVHandler(StateHandler):
    """Attention families: sequence state is refcounted KV pages."""

    name = "paged_kv"
    supports_prefix_sharing = True
    supports_speculative = True

    def require_scheduler_config(self) -> None:
        c = self.config
        if c is None or c.layout != "paged" or c.alloc != "dynamic":
            raise ValueError(
                "Scheduler needs CacheConfig(layout='paged', "
                f"alloc='dynamic'); got layout="
                f"{c.layout if c else None!r}, "
                f"alloc={c.alloc if c else None!r}")

    def occupancy(self, cache):
        """(used, total, per_shard) pages: per shard of its free lists
        (one read of the stack pointers), and their sums."""
        per_shard = alloc.shard_occupancy(cache)
        return (sum(u for u, _ in per_shard), sum(n for _, n in per_shard),
                per_shard)

    def admit(self, cache, slot, n_tokens):
        return alloc.admit_sequence(cache, slot, n_tokens)

    def free(self, cache, slot):
        """Retire row ``slot``, recycling the pages only it held."""
        return alloc.free_sequence(cache, slot)

    def fork(self, cache, parent, child, prefix_len, n_tokens):
        return alloc.fork_sequence(cache, parent, child, prefix_len,
                                   n_tokens, mesh=self.config.mesh)

    def reset_rows(self, cache, slot):
        """Point row ``slot``'s table at the scratch page, length 0 (its
        pages are not freed: that is ``free``)."""
        cache["page_table"][slot] = alloc.SCRATCH_PAGE
        cache["seq_lens"][slot] = 0
        return cache

    def slot_view(self, cache, b):
        """The pools are shared, and a prefill writes them in place
        through the row's own table entries."""
        view = dict(cache)
        view["page_table"] = cache["page_table"][b:b + 1]
        view["seq_lens"] = cache["seq_lens"][b:b + 1]
        return view

    def draft_fork(self, draft_cache, parent, child):
        for key in ("k", "v"):
            draft_cache[key][:, child] = draft_cache[key][:, parent]
        return draft_cache


class SlotStateHandler(StateHandler):
    """Pure SSM (mamba2): the batch row is the allocation unit.

    There is no pool: a free batch slot is free capacity, so ``admit``
    always succeeds (the scheduler's batch-full check is the only gate)
    and ``occupancy`` counts busy slots (``seq_lens > 0``).
    """

    name = "ssm_slot"
    # the per-row tensors a view slices (the model writes them in place)
    ROW_KEYS = SLOT_STATE_KEYS

    def require_scheduler_config(self) -> None:
        c = self.config
        if c is not None and c.layout != "dense":
            raise ValueError(
                f"family {self.cfg.family!r} keeps its O(1) SSM state "
                f"dense; got CacheConfig(layout={c.layout!r})")

    def occupancy(self, cache):
        total = int(cache["seq_lens"].shape[0])
        used = int((cache["seq_lens"] > 0).sum())
        return used, total, ((used, total),)

    def admit(self, cache, slot, n_tokens):
        # a zeroed slot is a fresh sequence
        return self.reset_rows(cache, slot), True

    def free(self, cache, slot):
        return self.reset_rows(cache, slot)

    def reset_rows(self, cache, slot):
        for key in SLOT_STATE_KEYS:
            cache[key][:, slot] = 0
        cache["seq_lens"][slot] = 0
        return cache

    def slot_view(self, cache, b):
        view = dict(cache)
        for key in self.ROW_KEYS:
            view[key] = cache[key][:, b:b + 1]
        view["seq_lens"] = cache["seq_lens"][b:b + 1]
        return view


class HybridHandler(SlotStateHandler):
    """zamba2: SSM slots plus the shared attention block's dense KV rows.

    ``shared_k/v`` travel with the slot in its views, but
    admission does not zero them: ``seq_lens`` governs visibility, so the
    previous occupant's stale KV is never attended, and zeroing S_max rows
    per admission would be write traffic for nothing.
    """

    name = "hybrid"
    ROW_KEYS = SLOT_STATE_KEYS + ("shared_k", "shared_v")


def state_handler(cfg: ModelConfig,
                  config: CacheConfig | None = None) -> StateHandler:
    """The registry: family → handler instance."""
    if cfg.family == "ssm":
        return SlotStateHandler(cfg, config)
    if cfg.family == "hybrid":
        return HybridHandler(cfg, config)
    return PagedKVHandler(cfg, config)


def default_serving_config(cfg: ModelConfig) -> CacheConfig:
    """The continuous-batching default per family: dynamic 16-token pages
    for attention KV, the dense layout for the slot families (their state
    is O(1): nothing to page)."""
    if is_ssm_family(cfg):
        return CacheConfig()
    return CacheConfig(layout="paged", alloc="dynamic", page_size=16)
