"""Decode-state (KV) cache: construction.

The dense layout, one rectangular buffer per tensor, as in the JAX package:

  k/v  (L, B, S_max, KVH, hd)

The serving engine and ``models/attention.py`` write new keys and values
into these tensors in place.  The paged layout (page pools plus page
tables, kernel K4) and the JAX ``CacheConfig`` that selects it are ROADMAP
queue 1, item 7; SSM and hybrid state come with item 12, and until then
``init_cache`` refuses their configs as ``init_model`` does.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Zero-initialised decode cache for ``batch`` sequences of up to
    ``max_len`` tokens, on ``device``.

    Returns ``{"k", "v"}``, each (L, B, max_len, KVH, hd) of ``dtype``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
