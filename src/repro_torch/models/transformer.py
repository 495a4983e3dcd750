"""Model assembly for the dense and MoE families: ``init_model`` /
``apply_model``.

Pre-norm decoder blocks (optionally gemma2 sandwich post-norms) run as a
Python loop over per-layer modules, the eager counterpart of the JAX
package's layer scan.  A block's FFN is dense, or under ``cfg.is_moe`` a
mixture of experts (``models/moe.py``), whose load-balance losses
``apply_model`` sums over the layers.  SSM, hybrid, vision-frontend and
encoder-decoder families are later ROADMAP items (queue 1, item 12) and
raise ``NotImplementedError``.

Cache convention (decode) — see serving/cache.py:
  dense:  {"k","v"}: (L, B, S_max, KVH, hd); layer i attends through the
          views cache["k"][i], cache["v"][i], written in place.
  paged:  {"k_pages","v_pages"}: (L, P, page, KVH, hd) page pools,
          {"k_scales","v_scales"}: (L, P, page, KVH) f32 (kv_quant="int8"),
          {"page_table"}: (B, max_pages) int32, {"seq_lens"}: (B,) int32;
          layer i attends through the views of its pools, written in
          place, and ``apply_model`` sets seq_lens to cache_pos + S (or
          cache_pos + n_valid in the speculative verify mode).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.attention import (Attention, apply_attention,
                                          init_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import FFN, apply_ffn, init_ffn
from repro_torch.models.layers import (Embedding, LMHead, Norm, apply_norm,
                                       embed_tokens, init_embedding,
                                       init_norm, sinusoidal_positions,
                                       unembed)
from repro_torch.models.moe import MoE, apply_moe, init_moe


class DecoderBlock(nn.Module):
    """Attention and a dense ``ffn``, or a mixture of experts ``moe``."""

    def __init__(self, norm_attn: Norm, attn: Attention, norm_ffn: Norm,
                 ffn: FFN | None, norm_attn_post: Norm | None = None,
                 norm_ffn_post: Norm | None = None, *,
                 moe: MoE | None = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("DecoderBlock takes exactly one of ffn and moe")
        self.norm_attn = norm_attn
        self.attn = attn
        self.norm_ffn = norm_ffn
        self.ffn = ffn
        self.moe = moe
        self.norm_attn_post = norm_attn_post
        self.norm_ffn_post = norm_ffn_post


class Model(nn.Module):
    def __init__(self, embed: Embedding, final_norm: Norm,
                 layers: list[DecoderBlock], lm_head: LMHead | None = None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.layers = nn.ModuleList(layers)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense and MoE families (for now)."""
    if (cfg.family not in ("dense", "moe") or cfg.frontend is not None
            or cfg.is_encoder_decoder):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            "queue 1, item 12); the port runs the dense and MoE families")


def _init_decoder_block(generator: torch.Generator,
                        cfg: ModelConfig) -> DecoderBlock:
    dev = generator.device
    post = cfg.post_block_norm
    attn = init_attention(generator, cfg)
    ffn = None if cfg.is_moe else init_ffn(generator, cfg)
    return DecoderBlock(
        init_norm(cfg, device=dev), attn, init_norm(cfg, device=dev), ffn,
        init_norm(cfg, device=dev) if post else None,
        init_norm(cfg, device=dev) if post else None,
        moe=init_moe(generator, cfg) if cfg.is_moe else None)


def init_model(generator: torch.Generator, cfg: ModelConfig, *,
               device="cuda", each_block=None) -> Model:
    """Random model from ``generator``, drawn on the generator's device and
    placed on ``device``.  A CPU generator gives the same weights whatever
    the target device.  ``each_block``, if given, maps each decoder block
    as soon as it is drawn (``quantize_model_params``), so a model too
    large in f32 is never whole in f32."""
    cfg.validate()
    check_supported(cfg)
    dev = resolve_device(device)
    embed = init_embedding(generator, cfg)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = LMHead(torch.randn((cfg.vocab_size, cfg.d_model),
                                     generator=generator,
                                     device=generator.device)
                         * (cfg.d_model ** -0.5))
    each_block = each_block or (lambda block: block)
    layers = [each_block(_init_decoder_block(generator, cfg))
              for _ in range(cfg.n_layers)]
    model = Model(embed, init_norm(cfg, device=generator.device), layers,
                  lm_head)
    return model.to(dev)


def _decoder_block(p: DecoderBlock, x, cfg: ModelConfig, *, positions,
                   is_local, cache_kv, cache_pos, page_table=None,
                   n_new=None):
    h = apply_norm(p.norm_attn, x, cfg)
    a_out, new_kv = apply_attention(p.attn, h, cfg, positions=positions,
                                    is_local=is_local, cache=cache_kv,
                                    cache_pos=cache_pos,
                                    page_table=page_table, n_new=n_new)
    if p.norm_attn_post is not None:
        a_out = apply_norm(p.norm_attn_post, a_out, cfg)
    x = x + cfg.residual_multiplier * a_out.to(x.dtype)

    h = apply_norm(p.norm_ffn, x, cfg)
    if p.moe is not None:
        f_out, aux = apply_moe(p.moe, h, cfg)
    else:
        f_out, aux = apply_ffn(p.ffn, h, cfg), {}
    if p.norm_ffn_post is not None:
        f_out = apply_norm(p.norm_ffn_post, f_out, cfg)
    x = x + cfg.residual_multiplier * f_out.to(x.dtype)
    return x, new_kv, aux


def _local_flags(cfg: ModelConfig) -> list[bool]:
    """Which layers use the sliding window (gemma2: even)."""
    if cfg.layer_pattern == "local_global" and cfg.sliding_window:
        return [i % 2 == 0 for i in range(cfg.n_layers)]
    return [bool(cfg.sliding_window)] * cfg.n_layers


def apply_model(model: Model, tokens: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None,
                cache_pos: torch.Tensor | int | None = None,
                n_valid: torch.Tensor | None = None):
    """Returns (logits f32 (B, S, V), cache, aux); ``aux`` holds the
    load-balance loss summed over the layers (0 for a dense model).

    tokens: (B, S) int decoder tokens.  ``cache``/``cache_pos``: the dense
    or paged decode cache (updated in place, and returned) and the write
    position — a scalar (batch-synchronous, made a (B,) vector here) or a
    (B,) int vector of per-sequence positions.  A paged cache comes back
    with ``seq_lens = cache_pos + S``.  DistilBERT runs causally here, as
    in the JAX package.

    ``n_valid`` (B,) int runs the paged cache in the speculative verify
    mode: of the S tokens only the first ``n_valid[b]`` of row b are
    committed; the others write to the allocator's scratch page and
    attend to nothing, and ``seq_lens`` comes back as ``cache_pos +
    n_valid``.  It needs a paged cache that carries the allocator.
    """
    check_supported(cfg)
    paged = cache is not None and "k_pages" in cache
    if n_valid is not None:
        if not paged:
            raise NotImplementedError(
                "n_valid (speculative verify) needs the paged cache layout")
        from repro_torch.serving.allocator import require_allocator
        require_allocator(cache, "apply_model(n_valid=)")
    x = embed_tokens(model.embed, tokens, cfg)
    b, s, _ = x.shape
    dev = x.device
    ar = torch.arange(s, device=dev)
    if cache is None:
        positions = ar                                      # (S,)
    else:
        cache_pos = torch.as_tensor(0 if cache_pos is None else cache_pos,
                                    device=dev).expand(b)
        positions = cache_pos[:, None] + ar[None, :]        # (B, S)
    if cfg.pos_embedding == "sinusoidal":
        pe = sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        x = x + (pe[None] if positions.dim() == 1 else pe)

    # each layer's slice of the cache: dense k/v, or the paged pools (and
    # the int8 layout's scale pools, which travel with their pages)
    kv_keys = [key for key in ("k", "v", "k_pages", "v_pages", "k_scales",
                               "v_scales") if cache is not None and key in cache]
    page_table = cache["page_table"] if paged else None
    lb = torch.zeros((), device=dev)
    for i, (layer, flag) in enumerate(zip(model.layers, _local_flags(cfg))):
        cache_kv = tuple(cache[key][i] for key in kv_keys) or None
        x, _, aux = _decoder_block(layer, x, cfg, positions=positions,
                                   is_local=flag, cache_kv=cache_kv,
                                   cache_pos=cache_pos,
                                   page_table=page_table, n_new=n_valid)
        if "load_balance_loss" in aux:
            lb = lb + aux["load_balance_loss"]
    if paged:
        cache["seq_lens"] = (cache_pos + (s if n_valid is None
                                          else n_valid)).to(torch.int32)

    x = apply_norm(model.final_norm, x, cfg)
    logits = unembed(model.embed, x, cfg, model.lm_head)
    return logits, cache, {"load_balance_loss": lb}
