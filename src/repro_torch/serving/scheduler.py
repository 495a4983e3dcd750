"""Continuous-batching scheduler: admit → step → retire.

The static serving loop (``engine.prefill`` → ``engine.greedy_decode``)
holds every sequence's state until the slowest one finishes.  This loop
serves a stream instead, speaking only the family's state-handler
contract (``serving/state.py``), so attention models serve over a paged
pool, mamba2 over per-row SSM slots and zamba2 over both through one
code path:

  * **admit** — while a batch slot is free and the handler can claim
    state for ``prompt + budget`` tokens (pages: admission waits when the
    pool cannot cover the head of the queue; SSM slots always admit),
    pop the next request and prefill its prompt.  If a live sequence
    shares a prompt prefix and the handler supports sharing, the
    prefix's full pages are aliased (``allocator.fork_sequence``:
    refcounted read-only sharing, the boundary page copied) and only the
    suffix is prefilled.
  * **step** — one decode step for the whole batch: ``serve_step`` at the
    cache's own ``seq_lens``, then argmax; or, with a ``SpecConfig``, one
    draft-and-verify tick (``engine.spec_step``) that emits 1..n_draft
    tokens per row.  Idle slots ride along masked (their table rows
    point at the scratch page; their lengths are pinned back to 0).
  * **retire** — finished sequences (budget spent or EOS) release their
    state through the handler: pages whose refcount reaches zero return
    to the free list, SSM slots zero their recurrent state.

Prompts are right-padded to a multiple of ``bucket`` before prefill, as
in the JAX package (there it bounds the number of compiled shapes; here
it keeps the two packages' writes, and so their results, the same).

The host reads back, per tick, the decode's tokens (plain: the argmax;
speculative: ``pred``, ``m`` and ``acc`` in one copy) and the pool's
stack pointers for the occupancy log; per admission, the allocator's
``ok`` and the first token.

Over a serving mesh (``CacheConfig(mesh=...)``) every rank runs its own
Scheduler on its shard of the model (``bridge.shard_model``) and its slab
of the pool, with the same requests in the same order: the allocator's
state, the admissions and the tokens are the same on every rank, so the
ranks stay in step through the forward's collectives.  Under the
``pages`` policy the allocator keeps per-shard free lists
(``pool_occupancy().per_shard``), and a prefix-shared admission copies
its boundary page across ranks.  ``spec=`` degrades to 1-token decode
under a mesh of more than one rank, as in the JAX package.  There is no
``_pin_shardings``: each rank's tensors are its own, placed once.  The
deprecated ``page_size=``/``pool_pages=``/``kv_quant=`` keywords are not
ported: ``config=`` is their spelling.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serving.cache import CacheConfig, init_cache
from repro_torch.serving.engine import (draft_prefill_row, prefill,
                                        serve_step, spec_step)
from repro_torch.serving.state import default_serving_config, state_handler

__all__ = ["Request", "Scheduler", "PoolOccupancy", "SpecConfig"]


class PoolOccupancy(NamedTuple):
    """Pool usage in the handler's units (pages, or busy batch slots for
    the SSM families): ``used``/``total``, and ((used, size), ...) per
    pool shard.  Admission gates on every shard covering its round-robin
    share, so the fullest shard of ``per_shard`` binds, not the total."""

    used: int
    total: int
    per_shard: tuple[tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Draft-and-verify speculative decode.

    ``draft_model``/``draft_cfg``: the proposal model — a smaller config
    or a truncated stack of the target (it must share the target's
    vocabulary).  ``n_draft``: tokens proposed per tick; the target
    verifies them (and the input token) in one ``n_draft + 1``-row pass
    through K4's verify mode, so each tick emits 1..n_draft tokens.

    The Scheduler honours it only where the family's state handler
    ``supports_speculative`` (the attention families); the SSM and hybrid
    families cannot rewind their recurrent state, and serve plain 1-token
    decode with a warning.
    """

    draft_model: Model
    draft_cfg: ModelConfig
    n_draft: int = 4


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` (token ids) and a budget.
    ``max_new_tokens`` bounds the page reservation at admission;
    generation may stop earlier on ``eos_id``."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int


@dataclasses.dataclass
class _Slot:
    """Host-side state of one live batch row."""

    req: Request
    generated: list
    last_token: int
    admitted: int = 0
    # the tick at which each generated token appeared (the admission tick
    # for the prefill's token)
    token_ticks: list = dataclasses.field(default_factory=list)


class Scheduler:
    """Continuous-batching serving loop over any ported family's decode
    state, through the state-handler registry (``serving/state.py``).

    Args:
      model / cfg: the model (dense, MoE, SSM, hybrid or vision family,
        the last text-only; an encoder-decoder is refused: its requests
        need memory, which the Scheduler's interface has no place for);
        ``cfg.family`` picks the state handler.
      slots: batch width B of the decode step.
      max_len: per-sequence context bound (the page table's width; the
        shared-KV S_max for hybrid; nothing for pure SSM, whose state is
        O(1)).
      config: a ``CacheConfig``.  Attention families need
        ``layout="paged"`` and ``alloc="dynamic"``: ``page_size``,
        ``pool_pages`` (may be far below ``slots * ceil(max_len /
        page_size)``: admission control and prefix sharing make
        oversubscription safe), ``kv_quant`` and ``mesh`` (this rank's
        mesh: ``model`` must be its shard).  The SSM families use the
        dense layout.  Default: ``default_serving_config`` (dynamic
        16-token pages; dense for SSM and hybrid).
      share_prefix: alias common prompt-prefix pages between live
        sequences instead of recomputing them.
      bucket: prompts are right-padded to a multiple of this.
      eos_id: optional early-stop token id.
      dtype: the KV storage dtype (int8 pools ignore it for the target).
      spec: a ``SpecConfig`` for speculative decode; greedy output is the
        plain decode's (bitwise with the plain versions on the CPU).
        Families whose handler lacks ``supports_speculative`` (SSM,
        hybrid), and any family under a mesh of more than one rank, warn
        and serve plain decode.
      device: where the caches live (default the card; raises without
        one).
    """

    def __init__(self, model: Model, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, config: CacheConfig | None = None,
                 share_prefix: bool = True, bucket: int = 16,
                 eos_id: int | None = None, dtype=torch.float32,
                 spec: SpecConfig | None = None, device="cuda"):
        if cfg.is_encoder_decoder:
            # the JAX Scheduler would prefill and decode without memory,
            # i.e. with no cross-attention at all
            raise NotImplementedError(
                f"{cfg.name}: the Scheduler serves decoder-only families; "
                "serve an encoder-decoder with encode(model, frames, cfg), "
                "then prefill / greedy_decode with memory=")
        if config is None:
            config = default_serving_config(cfg)
        model_mesh = getattr(model, "mesh", None)
        if config.model_size() != (1 if model_mesh is None
                                   else model_mesh.size):
            raise ValueError(
                f"CacheConfig mesh of {config.model_size()} ranks, model "
                f"sharded over {1 if model_mesh is None else model_mesh.size}"
                " (bridge.shard_model)")
        self.handler = state_handler(cfg, config)
        self.handler.require_scheduler_config()
        self.model, self.cfg, self.config = model, cfg, config
        self.device = resolve_device(device)
        self.page_size, self.bucket = config.page_size, bucket
        self.share_prefix = share_prefix
        self.eos_id = eos_id
        self.cache = init_cache(cfg, slots, max_len, dtype=dtype,
                                config=config, device=self.device)
        self.spec: SpecConfig | None = None
        self.draft_cache: dict | None = None
        # proposed / accepted draft tokens and emitted totals over the
        # speculative ticks
        self.spec_stats = {"ticks": 0, "proposed": 0, "accepted": 0,
                           "emitted": 0}
        if spec is not None and not self.handler.supports_speculative:
            warnings.warn(
                f"state handler {self.handler.name!r} does not support "
                "speculative rollback; degrading to 1-token decode",
                stacklevel=2)
        elif spec is not None and config.model_size() > 1:
            warnings.warn(
                "speculative decode is not supported over a sharded pool "
                f"(mesh of {config.model_size()} ranks); degrading to "
                "1-token decode", stacklevel=2)
        elif spec is not None:
            if spec.n_draft < 1:
                raise ValueError(f"n_draft must be >= 1, got {spec.n_draft}")
            self.spec = spec
            # the draft's dense cache holds KV through position
            # c + n_draft - 1, and c reaches capacity - 1
            cap = self.handler.capacity(self.cache) or max_len
            self.draft_cache = init_cache(spec.draft_cfg, slots,
                                          cap + spec.n_draft, dtype=dtype,
                                          device=self.device)
        self.slots: list[_Slot | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.finished: dict[int, np.ndarray] = {}
        # per-request event ticks (submitted / admitted / token_ticks),
        # kept after retirement
        self.request_log: dict[int, dict] = {}
        self.occupancy_log: list[int] = []
        # pages in use per pool shard after each tick
        self.shard_occupancy_log: list[tuple[int, ...]] = []
        self._next_rid = 0
        self._ticks = 0

    # -- request intake ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, rid: int | None = None):
        """Queue a request; returns its id.  Refuses, here rather than
        mid-tick, a request whose reservation could never fit the
        per-sequence table, or the hybrid family's shared-KV capacity (it
        would wedge the head of the queue)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1 or max_new_tokens < 1:
            raise ValueError("a request needs a prompt and a budget >= 1")
        if "page_table" in self.cache:
            width = self.cache["page_table"].shape[1]
            need = -(-(prompt.size + max_new_tokens) // self.page_size)
            if need > width:
                raise ValueError(
                    f"request needs {need} pages (prompt {prompt.size} + "
                    f"budget {max_new_tokens} tokens) but the table holds "
                    f"{width} (max_len {width * self.page_size})")
        else:
            # slot families: pure SSM has no positional bound (capacity
            # None); hybrid is bounded by the shared KV's S_max
            cap = self.handler.capacity(self.cache)
            if cap is not None and prompt.size + max_new_tokens > cap:
                raise ValueError(
                    f"request needs {prompt.size + max_new_tokens} tokens "
                    f"(prompt {prompt.size} + budget {max_new_tokens}) but "
                    f"the cache capacity is {cap} tokens")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        self.queue.append(Request(rid, prompt, max_new_tokens))
        self.request_log[rid] = {"submitted": self._ticks}
        return rid

    # -- introspection -----------------------------------------------------
    def pool_occupancy(self) -> PoolOccupancy:
        used, total, per_shard = self.handler.occupancy(self.cache)
        return PoolOccupancy(used, total, per_shard)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- the loop ----------------------------------------------------------
    def step(self) -> list[int]:
        """One tick: admit from the queue, one decode step for the live
        batch, retire what just finished (its pages return to the pool
        before the next tick's admissions).  Returns the ids of the
        requests that finished this tick."""
        self._admit()
        self._decode()
        done = self._retire()
        self._ticks += 1
        occ = self.pool_occupancy()
        self.occupancy_log.append(occ.used)
        self.shard_occupancy_log.append(tuple(u for u, _ in occ.per_shard))
        return done

    def run(self, max_ticks: int | None = None) -> dict[int, np.ndarray]:
        """``step`` until queue and batch drain; returns ``{rid: generated
        tokens}``.  ``max_ticks`` bounds the ticks of this call."""
        start = self._ticks
        while self.queue or self.n_active:
            self.step()
            if max_ticks is not None and self._ticks - start > max_ticks:
                raise RuntimeError(f"scheduler did not drain in "
                                   f"{max_ticks} ticks")
        return self.finished

    # -- internals ---------------------------------------------------------
    def _finished(self, slot: _Slot) -> bool:
        if len(slot.generated) >= slot.req.max_new_tokens:
            return True
        return self.eos_id is not None and slot.last_token == self.eos_id

    def _retire(self) -> list[int]:
        done = []
        for b, slot in enumerate(self.slots):
            if slot is not None and self._finished(slot):
                self.cache = self.handler.free(self.cache, b)
                if self.spec is not None:
                    self.draft_cache = self.handler.draft_free(
                        self.draft_cache, b)
                self.finished[slot.req.rid] = np.asarray(slot.generated,
                                                         np.int64)
                self.request_log[slot.req.rid].update(
                    admitted=slot.admitted, token_ticks=slot.token_ticks)
                done.append(slot.req.rid)
                self.slots[b] = None
        return done

    def _prefix_match(self, prompt: np.ndarray):
        """Longest shareable prefix with a live sequence: (slot, length).
        Capped at ``len(prompt) - 1`` (the last prompt token is prefilled,
        so its logits exist); a match shorter than a page is no match (it
        would alias no full page and copy one for nothing)."""
        best_b, best_len = -1, 0
        for b, slot in enumerate(self.slots):
            if slot is None:
                continue
            other = slot.req.prompt
            n = min(prompt.size - 1, other.size)
            eq = np.equal(prompt[:n], other[:n])
            common = n if eq.all() else int(eq.argmin())
            if common > best_len:
                best_b, best_len = b, common
        if best_len < self.page_size:
            return -1, 0
        return best_b, best_len

    def _admit(self):
        while self.queue:
            try:
                b = self.slots.index(None)
            except ValueError:
                return                       # batch full
            req = self.queue[0]
            budget = int(req.prompt.size) + req.max_new_tokens
            parent, shared = -1, 0
            if self.share_prefix and self.handler.supports_prefix_sharing:
                parent, shared = self._prefix_match(req.prompt)
            if shared > 0:
                self.cache, ok = self.handler.fork(
                    self.cache, parent, b, shared, budget)
                if bool(ok) and self.spec is not None:
                    # the child wakes with the parent's committed prefix:
                    # the draft must see the same context
                    self.draft_cache = self.handler.draft_fork(
                        self.draft_cache, parent, b)
            else:
                self.cache, ok = self.handler.admit(self.cache, b, budget)
            if not bool(ok):
                if self.n_active == 0:
                    raise RuntimeError(
                        f"request {req.rid} needs more pages than an empty "
                        f"pool of {self.pool_occupancy().total} offers")
                return                       # pool full: wait for retires
            self.queue.popleft()
            first = self._prefill_slot(b, req.prompt, start=shared)
            self.slots[b] = _Slot(req, [first], first,
                                  admitted=self._ticks,
                                  token_ticks=[self._ticks])

    def _prefill_slot(self, b: int, prompt: np.ndarray, start: int) -> int:
        """Commit ``prompt[start:]`` into row ``b`` (positions ``start..``)
        and return the first greedy token."""
        suffix = prompt[start:]
        padded = torch.from_numpy(
            np.pad(suffix, (0, -suffix.size % self.bucket))[None]).to(
                self.device)
        view = self.handler.slot_view(self.cache, b)
        next_logits, view = prefill(
            self.model, view, padded, torch.tensor([prompt.size]), self.cfg,
            start_pos=start)
        self.cache = self.handler.merge_slot(self.cache, view, b)
        if self.spec is not None:
            # the draft's dense row gets the prompt too (draft_fork copied
            # a shared prefix; only the suffix runs)
            self.draft_cache = draft_prefill_row(
                self.spec.draft_model, self.draft_cache, padded,
                int(prompt.size), start, b, self.spec.draft_cfg)
        return int(torch.argmax(next_logits[0]))

    def _batch_inputs(self):
        """(active (B,) bool, last tokens (B, 1)) on the cache's device."""
        active = torch.tensor([s is not None for s in self.slots],
                              device=self.device)
        tok = torch.tensor([[s.last_token if s else 0] for s in self.slots],
                           device=self.device)
        return active, tok

    def _decode(self):
        if not self.n_active:
            return
        if self.spec is not None:
            self._spec_decode()
            return
        active, tok = self._batch_inputs()
        logits, self.cache = serve_step(self.model, self.cache, tok, None,
                                        self.cfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).tolist()
        # idle rows advanced their (zero) lengths and wrote to the scratch
        # page: pin them back so their masked walk never grows
        self.cache = self.handler.advance(self.cache, active)
        for b, slot in enumerate(self.slots):
            if slot is not None and not self._finished(slot):
                slot.last_token = int(nxt[b])
                slot.generated.append(slot.last_token)
                slot.token_ticks.append(self._ticks)

    def _spec_decode(self):
        """One draft-and-verify tick: each live row emits 1..n_draft
        tokens, the rejected drafts rolled back in the engine.  The event
        log records one ``token_tick`` per emitted token."""
        spec = self.spec
        active, tok = self._batch_inputs()
        # a row at its budget already emits 0 and rolls its verify back
        budget_left = torch.tensor(
            [s.req.max_new_tokens - len(s.generated) if s else 0
             for s in self.slots], device=self.device)
        pred, m, acc, self.cache, self.draft_cache = spec_step(
            self.model, spec.draft_model, self.cache, self.draft_cache,
            tok, budget_left, active, self.cfg, spec.draft_cfg,
            n_draft=spec.n_draft, eos_id=self.eos_id)
        # the tick's one read-back: pred, m and acc in a single copy
        host = torch.cat([pred, m[:, None], acc[:, None]], dim=1).cpu()
        pred, m, acc = host[:, :-2], host[:, -2], host[:, -1]
        self.cache = self.handler.advance(self.cache, active)
        st = self.spec_stats
        st["ticks"] += 1
        st["proposed"] += self.n_active * spec.n_draft
        st["emitted"] += int(m.sum())
        st["accepted"] += int(acc.sum())
        for b, slot in enumerate(self.slots):
            if slot is None or not m[b]:
                continue
            emitted = pred[b, :int(m[b])].tolist()
            slot.generated.extend(emitted)
            slot.token_ticks.extend([self._ticks] * len(emitted))
            slot.last_token = emitted[-1]
