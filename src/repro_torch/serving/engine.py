"""Serving engine: prefill → decode handoff and the batched decode loop.

  * ``prefill`` runs the whole (right-padded) prompt batch through the
    cache-writing path in one pass, committing prompt KV into the dense
    cache and returning each sequence's next-token logits at its *own* last
    prompt position; a batch may mix prompt lengths.
  * ``serve_step`` is one decode step: B new tokens against per-sequence
    contexts.
  * ``greedy_decode`` is the batched serving loop, a Python loop over
    ``serve_step`` that updates the cache in place (the JAX package runs a
    jitted scan with the cache donated).

Per-sequence positions (``pos`` as a (B,) int vector) make mixed-length
batches exact: prefill padding beyond a short prompt is masked until the
decode loop overwrites it, one slot per step.  Chunked prefill
(``chunk=``), prefill onto a committed prefix (``start_pos=``),
cross-attention ``memory=`` and ``spec_step`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, apply_model


def validate_decode_cache(cache: dict, cfg: ModelConfig) -> None:
    """Fail loudly on a dense cache built for another model config."""
    want = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    for name in ("k", "v"):
        shape = tuple(cache[name].shape)
        if (shape[0],) + shape[3:] != want:
            raise ValueError(
                f"cache[{name!r}] has shape {shape}, but {cfg.name} needs "
                f"(L, KVH, hd) = {want} — was it built with a different "
                "model config?")


def cache_capacity(cache: dict) -> int:
    """Token capacity of a dense decode cache."""
    return cache["k"].shape[2]


def prefill(model: Model, cache: dict, prompts: torch.Tensor,
            prompt_lens: torch.Tensor, cfg: ModelConfig):
    """Prefill → decode handoff: commit prompt KV, return first logits.

    prompts (B, S_pad) int, right-padded to the longest prompt; prompt_lens
    (B,) true lengths (may differ per sequence).  The whole padded batch
    runs through the cache-writing path at positions ``0..S_pad-1``; slots
    past ``prompt_lens[b]`` hold padding garbage that decode masks per
    sequence until it overwrites them.

    Returns (next_logits (B, V) f32 at each sequence's last real prompt
    token, the cache — updated in place).
    """
    b, s_pad = prompts.shape
    validate_decode_cache(cache, cfg)
    capacity = cache_capacity(cache)
    if s_pad > capacity:
        raise ValueError(f"prompt width {s_pad} exceeds cache capacity "
                         f"{capacity} tokens")
    dev = prompts.device
    prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.long, device=dev)
    logits, cache, _ = apply_model(model, prompts, cfg, cache=cache,
                                   cache_pos=0)
    next_logits = logits[torch.arange(b, device=dev), prompt_lens - 1]
    return next_logits, cache


def serve_step(model: Model, cache: dict, tokens: torch.Tensor,
               pos, cfg: ModelConfig):
    """One decode step.

    tokens (B, 1) int; pos is a scalar (batch-synchronous) or a (B,) int
    vector of per-sequence lengths (mixed-length batches).

    Returns (logits (B, 1, V) f32, cache — updated in place).
    """
    validate_decode_cache(cache, cfg)
    if pos is None:
        raise ValueError("the dense cache needs an explicit pos")
    logits, cache, _ = apply_model(model, tokens, cfg, cache=cache,
                                   cache_pos=pos)
    return logits, cache


def greedy_decode(model: Model, cache: dict, first_token: torch.Tensor,
                  start_pos, n_steps: int, cfg: ModelConfig):
    """Batched greedy serving loop over ``n_steps`` decode steps.

    first_token (B, 1) int; start_pos is an int (batch-synchronous) or a
    (B,) int vector of per-sequence lengths.

    Returns (tokens (B, n_steps + 1) — ``first_token`` followed by the
    greedy continuations — and the cache, updated in place).
    """
    validate_decode_cache(cache, cfg)
    dev = first_token.device
    pos = torch.as_tensor(start_pos, dtype=torch.long, device=dev)
    tok = first_token
    out = [first_token]
    for _ in range(n_steps):
        logits, cache = serve_step(model, cache, tok, pos, cfg)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            first_token.dtype)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1), cache
