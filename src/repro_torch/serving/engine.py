"""Serving engine: the cache-less prefill, the prefill → decode handoff and
the batched decode loop.

  * ``prefill_step`` is the cache-less forward of a prompt batch: logits
    for every position, no cache written.  Prompts of at least
    ``cfg.blockwise_attn_threshold`` tokens attend blockwise (the
    block-sparse flash kernel K5 on the card), never holding the whole
    (S, S) score block.  It takes the vision family's patch embeddings
    (``frontend_embeds``, spliced ahead of the text) and the
    encoder-decoder family's frames (``encoder_frames``, encoded first).
  * ``prefill`` runs the whole (right-padded) prompt batch through the
    cache-writing path — one pass, or fixed-size chunks (``chunk=``) —
    committing prompt KV into the cache (dense rows or paged pools; for
    the SSM and hybrid families the recurrent state, advanced by each
    row's own valid tokens, and the shared block's KV) and returning each
    sequence's next-token logits at its *own* last prompt position; a
    batch may mix prompt lengths.
  * ``serve_step`` is one decode step: B new tokens against per-sequence
    contexts.
  * ``greedy_decode`` is the batched serving loop, a Python loop over
    ``serve_step`` that updates the cache in place (the JAX package runs a
    jitted scan with the cache donated).

  * ``spec_step`` is one speculative draft-and-verify tick: the draft
    model proposes ``n_draft`` greedy tokens per row from its dense
    cache, the target verifies them in one pass through K4's verify mode,
    and acceptance and rollback run on the device.

Per-sequence positions (``pos`` as a (B,) int vector, or the paged
cache's own ``seq_lens``) make mixed-length batches exact: prefill padding
beyond a short prompt is written but not committed, masked until the
decode loop overwrites it, one slot per step.  ``prefill(start_pos=)``
prefills a suffix onto a committed prefix (a prefix-shared admission).
An encoder-decoder is served by ``encode`` once, then ``prefill``,
``serve_step`` and ``greedy_decode`` with that ``memory=``: every
decoder layer cross-attends to it at every step (the cache holds the
decoder's self-attention KV only).  ``spec_step`` takes no memory, as in
the JAX package, so it raises on an encoder-decoder.

Over a serving mesh each rank calls these with its shard of the model
(``bridge.shard_model``) and its slab of the cache (``CacheConfig(mesh=)``):
the JAX package's ``_mesh_context`` is the model's own ``mesh``, which the
forward reduces over (``models/transformer.py``).  Every rank gets the same
logits and tokens.  ``prefill_step`` (cache-less, K5 on each rank's
heads, the vision family's patches and the encoder-decoder's frames
included) and the cached entries with ``memory=`` run under a mesh for
every family; ``spec_step`` (the verify mode) raises under a mesh of more
than one rank.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Model, apply_model,
                                            is_ssm_family)
from repro_torch.serving.allocator import require_allocator
from repro_torch.serving.cache import PAGE_STATE_KEYS, invalidate_token_rows


def prefill_step(model: Model, tokens: torch.Tensor, cfg: ModelConfig, *,
                 frontend_embeds=None, encoder_frames=None):
    """Cache-less forward pass producing logits for a prompt batch.

    tokens (B, S) int.  Returns (logits f32 (B, S, V), aux), or (B, P +
    S, V) with ``frontend_embeds`` (B, P, D).  ``encoder_frames`` (B, T, D)
    are encoded first and every decoder layer cross-attends to them.  This
    is the throughput-shape entry of long-prompt prefill; the serving
    handoff that also commits KV is ``prefill``.
    """
    logits, _, aux = apply_model(model, tokens, cfg,
                                 frontend_embeds=frontend_embeds,
                                 encoder_frames=encoder_frames)
    return logits, aux


def validate_decode_cache(cache: dict, cfg: ModelConfig, mesh=None) -> None:
    """Fail loudly on a cache built for another model config (or another
    mesh: under the cache's ``kv_shard`` ``"heads"`` a rank's pools hold
    ``n_kv_heads / m`` heads of the model's ``mesh``), or on a layout the
    decode path cannot execute (int8 pages without their scale pools
    would be read as raw integers)."""
    if ("ssm_h" in cache) != is_ssm_family(cfg):
        # a family/cache mismatch would run the wrong layer loop over the
        # wrong state
        got = "SSM slot state" if "ssm_h" in cache else "attention KV"
        raise ValueError(
            f"cache carries {got} but cfg.family is {cfg.family!r} — was "
            "it built with a different model config?")
    paged = "k_pages" in cache
    kvh = cfg.n_kv_heads
    if cache.get("kv_shard") == "heads":
        if mesh is None:
            raise ValueError("a cache split by KV heads over a mesh, "
                             "served without the model's mesh")
        kvh //= mesh.size
    want = (cfg.n_layers, kvh, cfg.head_dim)
    for name in PAGE_STATE_KEYS if paged else ("k", "v"):
        if name not in cache:
            continue
        # (L, B|P, S|page, KVH, hd); scale pools lack the trailing hd
        shape = tuple(cache[name].shape)
        if (shape[0],) + shape[3:] != want[:len(shape) - 2]:
            raise ValueError(
                f"cache[{name!r}] has shape {shape}, but {cfg.name} needs "
                f"(L, KVH, hd) = {want} — was it built with a different "
                "model config?")
    if paged:
        kd, vd = cache["k_pages"].dtype, cache["v_pages"].dtype
        has_scales = "k_scales" in cache or "v_scales" in cache
        combo = (f"layout='paged', kv dtype {kd}, kv_quant="
                 f"{'int8' if has_scales else 'none'}")
        if not kd.is_floating_point and not has_scales:
            raise NotImplementedError(
                f"unsupported decode cache combo ({combo}): integer KV "
                "pages need their k_scales/v_scales pools — build the "
                "cache with CacheConfig(kv_quant='int8')")
        if has_scales:
            if "k_scales" not in cache or "v_scales" not in cache:
                raise NotImplementedError(
                    f"unsupported decode cache combo ({combo}): the "
                    "quantized page layout needs BOTH k_scales and "
                    "v_scales")
            if kd != torch.int8 or vd != torch.int8:
                raise NotImplementedError(
                    f"unsupported decode cache combo ({combo}): scale "
                    "pools are present but the pages are not int8")
    elif "k" in cache and not cache["k"].dtype.is_floating_point:
        raise NotImplementedError(
            f"unsupported decode cache combo (layout='dense', kv dtype "
            f"{cache['k'].dtype}): quantized KV is only implemented for "
            "the paged layout (CacheConfig(layout='paged', "
            "kv_quant='int8'))")


def cache_capacity(cache: dict, mesh=None) -> int | None:
    """Token capacity of a decode cache, or None for pure-SSM state (O(1)
    in context length: no positional capacity to exceed).  ``mesh``: the
    model's, whose ranks each hold S_max/m positions of a dense cache
    split by sequence (its ``kv_shard`` ``"pages"``)."""
    if "k_pages" in cache:
        return cache["page_table"].shape[1] * cache["k_pages"].shape[2]
    # hybrid: the shared block's sites hold the only positional buffers,
    # and their S_max bounds the context
    key = "k" if "k" in cache else "shared_k" if "shared_k" in cache else None
    if key is None:
        return None
    if cache.get("kv_shard") == "pages":
        if mesh is None:
            raise ValueError("a dense cache split by sequence over a mesh, "
                             "read without the model's mesh")
        return cache[key].shape[2] * mesh.size
    return cache[key].shape[2]


def prefill(model: Model, cache: dict, prompts: torch.Tensor,
            prompt_lens: torch.Tensor, cfg: ModelConfig, *,
            memory: torch.Tensor | None = None,
            chunk: int | None = None, start_pos: int = 0):
    """Prefill → decode handoff: commit prompt KV, return first logits.

    prompts (B, S_pad) int, right-padded to the longest prompt; prompt_lens
    (B,) true lengths (may differ per sequence).  The whole padded batch
    runs through the cache-writing path at positions ``0..S_pad-1``; slots
    past ``prompt_lens[b]`` hold padding that decode masks per sequence
    until it overwrites them.  ``chunk`` commits the prompt in chunks of
    that many positions, each attending over what earlier chunks wrote.
    ``start_pos > 0`` prefills a suffix: the first ``start_pos``
    positions are already committed (a prefix-shared admission,
    ``allocator.fork_sequence``), ``prompts`` holds the tokens from there
    on and the run sits at positions ``start_pos..``; ``prompt_lens``
    stays absolute (prefix and suffix).

    On an SSM / hybrid cache each row's valid-token count (``prompt_lens
    - start``, clipped to the pass's width) rides into the model: the
    recurrence cannot mask padding after the fact, so padded steps leave
    the state untouched.

    ``memory`` (B, T, D): an encoder-decoder's encoded frames
    (``encode``), which every pass cross-attends to (required there).

    Returns (next_logits (B, V) f32 at each sequence's last real prompt
    token, the cache — updated in place, a paged or SSM one with
    ``seq_lens = prompt_lens``).
    """
    b, s_pad = prompts.shape
    validate_decode_cache(cache, cfg, getattr(model, "mesh", None))
    capacity = cache_capacity(cache, getattr(model, "mesh", None))
    if capacity is not None and start_pos + s_pad > capacity:
        # past capacity the page-table lookup would fault on the card
        raise ValueError(f"prompt width {start_pos + s_pad} exceeds cache "
                         f"capacity {capacity} tokens")
    dev = prompts.device
    prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    is_ssm = "ssm_h" in cache

    def valid(c0, width):
        # the SSM state's committed tokens in the pass at c0 (else None)
        if not is_ssm:
            return None
        return (prompt_lens - (start_pos + c0)).clamp(0, width)

    if chunk is None or s_pad <= chunk:
        logits, cache, _ = apply_model(model, prompts, cfg, cache=cache,
                                       cache_pos=start_pos, memory=memory,
                                       n_valid=valid(0, s_pad))
        next_logits = logits[rows, prompt_lens - 1 - start_pos]
    else:
        next_logits = None
        for c0 in range(0, s_pad, chunk):
            cs = min(chunk, s_pad - c0)
            logits, cache, _ = apply_model(model, prompts[:, c0:c0 + cs],
                                           cfg, cache=cache,
                                           cache_pos=start_pos + c0,
                                           memory=memory,
                                           n_valid=valid(c0, cs))
            if next_logits is None:
                next_logits = torch.zeros((b, logits.shape[-1]),
                                          dtype=logits.dtype, device=dev)
            # each sequence's last prompt token lies in exactly one chunk
            rel = prompt_lens - 1 - start_pos - c0
            inside = (rel >= 0) & (rel < cs)
            got = logits[rows, rel.clamp(0, cs - 1)]
            next_logits = torch.where(inside[:, None], got, next_logits)
    if "seq_lens" in cache:
        # padded tails were written but are not committed: decode
        # overwrites them slot by slot
        cache["seq_lens"] = prompt_lens.to(torch.int32)
    return next_logits, cache


def serve_step(model: Model, cache: dict, tokens: torch.Tensor,
               pos, cfg: ModelConfig, *, memory: torch.Tensor | None = None):
    """One decode step.

    tokens (B, 1) int; pos is a scalar (batch-synchronous), a (B,) int
    vector of per-sequence lengths (mixed-length batches), or None to read
    the cache's own ``seq_lens`` (paged and SSM caches carry them).  Every
    position must lie below ``cache_capacity(cache)`` (where it is not
    None): a scalar is checked here, but a device vector is not (that
    would read it on the host every step), and past capacity its write
    faults on the card.  ``greedy_decode`` checks its whole run once.
    ``memory``: an encoder-decoder's encoded frames (required there).

    Returns (logits (B, 1, V) f32, cache — updated in place).
    """
    validate_decode_cache(cache, cfg, getattr(model, "mesh", None))
    capacity = cache_capacity(cache, getattr(model, "mesh", None))
    if (isinstance(pos, int) and capacity is not None
            and pos + tokens.shape[1] > capacity):
        raise ValueError(f"decode position {pos} exceeds cache capacity "
                         f"{capacity} tokens")
    if pos is None:
        if "seq_lens" not in cache:
            raise ValueError("pos=None needs a cache carrying seq_lens (the "
                             "paged layout or SSM state); a dense cache "
                             "needs an explicit pos")
        pos = cache["seq_lens"]
    logits, cache, _ = apply_model(model, tokens, cfg, cache=cache,
                                   cache_pos=pos, memory=memory)
    return logits, cache


def greedy_decode(model: Model, cache: dict, first_token: torch.Tensor,
                  start_pos, n_steps: int, cfg: ModelConfig, *,
                  memory: torch.Tensor | None = None):
    """Batched greedy serving loop over ``n_steps`` decode steps.

    first_token (B, 1) int; start_pos is an int (batch-synchronous), a
    (B,) int vector of per-sequence lengths, or None to start from the
    cache's ``seq_lens`` (paged and SSM caches).  ``memory``: an
    encoder-decoder's encoded frames, which every step cross-attends to.

    Returns (tokens (B, n_steps + 1) — ``first_token`` followed by the
    greedy continuations — and the cache, updated in place).
    """
    validate_decode_cache(cache, cfg, getattr(model, "mesh", None))
    dev = first_token.device
    if start_pos is None:
        if "seq_lens" not in cache:
            raise ValueError("start_pos=None needs a cache carrying "
                             "seq_lens (the paged layout or SSM state)")
        start_pos = cache["seq_lens"]
    pos = torch.as_tensor(start_pos, device=dev).long()
    # one host read per call, not per step: past capacity a write would
    # fault on the card (pure-SSM state has no capacity)
    capacity = cache_capacity(cache, getattr(model, "mesh", None))
    if (n_steps and capacity is not None
            and int(pos.max()) + n_steps > capacity):
        raise ValueError(f"{n_steps} decode steps from position "
                         f"{int(pos.max())} exceed cache capacity "
                         f"{capacity} tokens")
    tok = first_token
    out = [first_token]
    for _ in range(n_steps):
        logits, cache = serve_step(model, cache, tok, pos, cfg,
                                   memory=memory)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            first_token.dtype)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), cache


def spec_step(model: Model, draft_model: Model, cache: dict,
              draft_cache: dict, tokens: torch.Tensor,
              budget_left: torch.Tensor, active: torch.Tensor,
              cfg: ModelConfig, draft_cfg: ModelConfig, *, n_draft: int,
              eos_id: int | None = None):
    """One speculative draft-and-verify tick.

    ``tokens`` (B, 1) int: each live row's last emitted token;
    ``budget_left`` (B,) int: tokens each row may still emit; ``active``
    (B,) bool.  ``cache`` is the target's paged cache, which must carry
    the allocator (the verify pass and the rollback send masked writes to
    its scratch page); ``draft_cache`` the draft's dense cache.

    With committed lengths ``c``, the draft proposes ``n_draft`` greedy
    tokens ``d_1..d_n`` at positions ``c..c+n-1``; the target runs
    ``[x0, d_1..d_n]`` at ``c..c+n`` in one pass (K4's verify mode: idle
    rows are all dead) and ``pred[r]`` is its greedy token after position
    ``c+r``.  With ``k`` the drafts' leading agreement with ``pred``, a
    row emits ``m = min(k+1, n)`` tokens (not ``n+1``: the draft cache
    holds KV only through ``c+n-1``), capped at the first emitted EOS and
    at ``budget_left``; 0 for idle rows.  Rollback: ``seq_lens = c + m``
    and the written-but-rejected rows are zeroed in every page array
    (``invalidate_token_rows``).  Both caches are updated in place.  All
    of it runs on the device: nothing is read back here.

    Returns ``(pred (B, n_draft+1), m (B,), acc (B,) = min(k, m) — how
    many of the emitted tokens were draft proposals, cache, draft_cache)``.
    """
    validate_decode_cache(cache, cfg)
    require_allocator(cache, "spec_step")
    if n_draft < 1:
        raise ValueError(f"spec_step needs n_draft >= 1, got {n_draft}")
    dev = tokens.device
    c = cache["seq_lens"].long()
    s = n_draft + 1
    drafts = []
    dtok = tokens
    for t in range(n_draft):
        lg, draft_cache = serve_step(draft_model, draft_cache, dtok, c + t,
                                     draft_cfg)
        dtok = torch.argmax(lg[:, -1, :], dim=-1)[:, None].to(tokens.dtype)
        drafts.append(dtok)
    drafts = torch.cat(drafts, dim=1)                       # (B, n_draft)
    verify = torch.cat([tokens, drafts], dim=1)             # (B, S)
    active = active.to(dev)
    n_valid = torch.where(active, s, 0).to(torch.int32)
    logits, cache, _ = apply_model(model, verify, cfg, cache=cache,
                                   cache_pos=c, n_valid=n_valid)
    pred = torch.argmax(logits, dim=-1)                     # (B, S)
    match = (pred[:, :n_draft] == drafts).to(torch.int32)
    k = torch.cumprod(match, dim=1).sum(dim=1)              # leading agrees
    m = torch.clamp(k + 1, max=n_draft)
    if eos_id is not None:
        eos_hit = pred == eos_id
        first = eos_hit.to(torch.int32).argmax(dim=1) + 1
        m = torch.where(eos_hit.any(dim=1), torch.minimum(m, first), m)
    m = torch.minimum(m, budget_left.to(dev).long())
    m = torch.where(active, m, 0)
    row = torch.arange(s, device=dev)[None, :]
    rejected = (row >= m[:, None]) & (row < n_valid[:, None])
    invalidate_token_rows(cache, c[:, None] + row, rejected)
    cache["seq_lens"] = torch.where(active, c + m, 0).to(torch.int32)
    return pred, m, torch.minimum(k, m), cache, draft_cache


def draft_prefill_row(draft_model: Model, draft_cache: dict,
                      prompts: torch.Tensor, prompt_len: int, start_pos: int,
                      slot: int, draft_cfg: ModelConfig) -> dict:
    """Commit a prompt (1, S_pad), from position ``start_pos``, into row
    ``slot`` of the dense draft cache, in place: the prefill writes
    through views of that row alone.  The draft's logits are discarded
    (the first spec tick drafts from the target's first token)."""
    view = {key: draft_cache[key][:, slot:slot + 1] for key in ("k", "v")}
    prefill(draft_model, view, prompts, torch.tensor([prompt_len]),
            draft_cfg, start_pos=start_pos)
    return draft_cache
