"""Model assembly for every family: ``init_model`` / ``apply_model`` /
``encode``.

Pre-norm decoder blocks (optionally gemma2 sandwich post-norms) run as a
Python loop over per-layer modules, the eager counterpart of the JAX
package's layer scan.  A block's FFN is dense, or under ``cfg.is_moe`` a
mixture of experts (``models/moe.py``), whose load-balance losses
``apply_model`` sums over the layers.  The ``ssm`` family (mamba2) is a
stack of Mamba2 blocks (``SSMBlock``, ``models/ssm.py``); the ``hybrid``
family (zamba2) adds one parameter-shared attention + FFN block
(``Model.shared_attn``) that runs before the Mamba block of every layer
``i`` with ``i % shared_attn_every == shared_attn_every - 1``, each such
site with its own KV cache.  The vision family (phi-3-vision) splices
precomputed patch embeddings ahead of the text tokens of a cache-less
forward (``frontend_embeds``); its decode is text-only.  The
encoder-decoder family (seamless-m4t) adds a bidirectional ``Encoder``
over precomputed frame embeddings (``encode``) and a cross-attention
sub-block in every decoder block, which attends to the encoder's output
(``memory``): ``apply_model`` encodes ``encoder_frames`` itself on a
cache-less call, and a decode call takes the ``memory`` encoded once
beforehand.  Where the JAX package would silently drop an input (frames
or patches it cannot use, a cached call without memory) the port raises.
Under ``cfg.remat == "block"`` with grad enabled (training) every decoder,
Mamba and encoder block runs as an activation checkpoint (``_remat``).

Over a serving mesh (``bridge.shard_model`` sets ``model.mesh`` and gives
each rank its slices) the forward is the rank's: the vocab-parallel
embedding and head, column- and row-parallel projections and the sharded
paged attention (``models/attention.py``) reduce over the mesh so that the
residual stream, the norms and the logits are the same bits on every rank
(ranks that picked different greedy tokens would wait on each other in a
collective).  Dense attention families only, on a cache (ROADMAP queue 1,
item 13 for the rest).

Cache convention (decode) — see serving/cache.py:
  dense:  {"k","v"}: (L, B, S_max, KVH, hd); layer i attends through the
          views cache["k"][i], cache["v"][i], written in place.
  paged:  {"k_pages","v_pages"}: (L, P, page, KVH, hd) page pools,
          {"k_scales","v_scales"}: (L, P, page, KVH) f32 (kv_quant="int8"),
          {"page_table"}: (B, max_pages) int32, {"seq_lens"}: (B,) int32;
          layer i attends through the views of its pools, written in
          place, and ``apply_model`` sets seq_lens to cache_pos + S (or
          cache_pos + n_valid in the speculative verify mode).
  ssm / hybrid: {"ssm_h"}: (L, B, H, P, N) f32, {"conv_x","conv_B",
          "conv_C"}: (L, B, k-1, ·) f32 conv tails, {"seq_lens"}: (B,)
          int32, and for hybrid {"shared_k","shared_v"}: (sites, B, S_max,
          KVH, hd), site i the i-th application of the shared block; each
          layer's state is written back in place, and ``apply_model`` sets
          seq_lens to cache_pos + S (or + n_valid).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models.ssm import Mamba2, apply_mamba2, init_mamba2

# the per-layer recurrent state of an SSM or hybrid cache, as the blocks'
# state dict names it ({"h", "conv_x", "conv_B", "conv_C"})
SSM_STATE = {"ssm_h": "h", "conv_x": "conv_x", "conv_B": "conv_B",
             "conv_C": "conv_C"}


class DecoderBlock(nn.Module):
    """Attention and a dense ``ffn``, or a mixture of experts ``moe``; in
    an encoder-decoder's decoder also ``cross``-attention to the encoder's
    output, after its norm ``norm_cross``."""

    def __init__(self, norm_attn: Norm, attn: Attention, norm_ffn: Norm,
                 ffn: FFN | None, norm_attn_post: Norm | None = None,
                 norm_ffn_post: Norm | None = None, *,
                 moe: MoE | None = None, norm_cross: Norm | None = None,
                 cross: Attention | None = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("DecoderBlock takes exactly one of ffn and moe")
        if (norm_cross is None) != (cross is None):
            raise ValueError("DecoderBlock takes norm_cross and cross "
                             "together")
        self.norm_attn = norm_attn
        self.attn = attn
        self.norm_ffn = norm_ffn
        self.ffn = ffn
        self.moe = moe
        self.norm_attn_post = norm_attn_post
        self.norm_ffn_post = norm_ffn_post
        self.norm_cross = norm_cross
        self.cross = cross


class Encoder(nn.Module):
    """The encoder-decoder family's bidirectional encoder: pre-norm blocks
    (``DecoderBlock``s without cross-attention) and its final norm."""

    def __init__(self, layers: list[DecoderBlock], final_norm: Norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


class SSMBlock(nn.Module):
    """A pre-norm Mamba2 block: ``norm``, then ``mamba``."""

    def __init__(self, norm: Norm, mamba: Mamba2):
        super().__init__()
        self.norm = norm
        self.mamba = mamba


class Model(nn.Module):
    """Embedding, the layer stack (``DecoderBlock``s, or ``SSMBlock``s for
    the SSM and hybrid families), the final norm, an untied head if any,
    the hybrid family's ``shared_attn`` block and the encoder-decoder
    family's ``encoder``."""

    def __init__(self, embed: Embedding, final_norm: Norm,
                 layers: list[nn.Module], lm_head: LMHead | None = None,
                 shared_attn: DecoderBlock | None = None,
                 encoder: Encoder | None = None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.layers = nn.ModuleList(layers)
        self.shared_attn = shared_attn
        self.encoder = encoder


# every family of the JAX package; the port runs them all
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a config of a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port runs "
            f"{', '.join(FAMILIES)}")


def check_mesh_supported(cfg: ModelConfig) -> None:
    """Refuse a family the port does not serve over a mesh yet."""
    if cfg.is_moe or is_ssm_family(cfg) or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) under a mesh: the port's meshes "
            "serve the dense attention families; MoE (expert and data "
            "parallel), SSM and hybrid (ssm_heads / ssm_inner) and the "
            "encoder-decoder's memory= are ROADMAP queue 1, item 13")


def is_ssm_family(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def shared_sites(cfg: ModelConfig) -> list[bool]:
    """Which layers run the hybrid family's shared block before their
    Mamba block: ``i % every == every - 1`` (none outside the family)."""
    every = cfg.shared_attn_every
    if cfg.family != "hybrid" or every <= 0:
        return [False] * cfg.n_layers
    return [i % every == every - 1 for i in range(cfg.n_layers)]


def _init_decoder_block(generator: torch.Generator, cfg: ModelConfig, *,
                        cross: bool = False) -> DecoderBlock:
    dev = generator.device
    post = cfg.post_block_norm
    attn = init_attention(generator, cfg)
    ffn = None if cfg.is_moe else init_ffn(generator, cfg)
    return DecoderBlock(
        init_norm(cfg, device=dev), attn, init_norm(cfg, device=dev), ffn,
        init_norm(cfg, device=dev) if post else None,
        init_norm(cfg, device=dev) if post else None,
        moe=init_moe(generator, cfg) if cfg.is_moe else None,
        norm_cross=init_norm(cfg, device=dev) if cross else None,
        cross=init_attention(generator, cfg) if cross else None)


def init_model(generator: torch.Generator, cfg: ModelConfig, *,
               device="cuda", each_block=None) -> Model:
    """Random model from ``generator``, drawn on the generator's device and
    placed on ``device``.  A CPU generator gives the same weights whatever
    the target device.  ``each_block``, if given, maps each block (decoder
    or Mamba, and the hybrid family's shared block) as soon as it is drawn
    (``quantize_model_params``), so a model too large in f32 is never
    whole in f32.  An encoder-decoder config also gets its ``Encoder``
    (``n_encoder_layers`` blocks, each mapped alike) and cross-attention
    in every decoder block."""
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
    shared = encoder = None
    if is_ssm_family(cfg):
        layers = [each_block(SSMBlock(init_norm(cfg, device=generator.device),
                                      init_mamba2(generator, cfg)))
                  for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            shared = each_block(_init_decoder_block(generator, cfg))
    else:
        if cfg.is_encoder_decoder:
            encoder = Encoder(
                [each_block(_init_decoder_block(generator, cfg))
                 for _ in range(cfg.n_encoder_layers)],
                init_norm(cfg, device=generator.device))
        layers = [each_block(_init_decoder_block(
                      generator, cfg, cross=cfg.is_encoder_decoder))
                  for _ in range(cfg.n_layers)]
    model = Model(embed, init_norm(cfg, device=generator.device), layers,
                  lm_head, shared, encoder)
    return model.to(dev)


def _remat(cfg: ModelConfig, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; under ``cfg.remat == "block"`` with grad
    enabled (training), as a non-reentrant activation checkpoint: the block
    keeps only its inputs and runs again in the backward, as the JAX
    package's ``jax.checkpoint`` of each block.  Serving runs with grad off
    and is unchanged."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def _decoder_block(p: DecoderBlock, x, cfg: ModelConfig, *, positions,
                   is_local, cache_kv, cache_pos, page_table=None,
                   n_new=None, memory=None, kv_shard=None):
    h = apply_norm(p.norm_attn, x, cfg)
    a_out, new_kv = apply_attention(p.attn, h, cfg, positions=positions,
                                    is_local=is_local, cache=cache_kv,
                                    cache_pos=cache_pos,
                                    page_table=page_table, n_new=n_new,
                                    kv_shard=kv_shard)
    if p.norm_attn_post is not None:
        a_out = apply_norm(p.norm_attn_post, a_out, cfg)
    x = x + cfg.residual_multiplier * a_out.to(x.dtype)

    if memory is not None:
        h = apply_norm(p.norm_cross, x, cfg)
        c_out, _ = apply_attention(p.cross, h, cfg, positions=positions,
                                   memory=memory)
        x = x + cfg.residual_multiplier * c_out.to(x.dtype)

    h = apply_norm(p.norm_ffn, x, cfg)
    if p.moe is not None:
        f_out, aux = apply_moe(p.moe, h, cfg)
    else:
        f_out, aux = apply_ffn(p.ffn, h, cfg), {}
    if p.norm_ffn_post is not None:
        f_out = apply_norm(p.norm_ffn_post, f_out, cfg)
    x = x + cfg.residual_multiplier * f_out.to(x.dtype)
    return x, new_kv, aux


def _ssm_block(p: SSMBlock, x, cfg: ModelConfig, *, ssm_state,
               n_valid=None):
    h = apply_norm(p.norm, x, cfg)
    y, new_state = apply_mamba2(p.mamba, h, cfg, state=ssm_state,
                                n_valid=n_valid)
    return x + cfg.residual_multiplier * y.to(x.dtype), new_state


def _ssm_stack(model: Model, x, cfg: ModelConfig, *, positions, cache,
               cache_pos, n_valid=None):
    """The SSM / hybrid layer loop (the reference's ``_scan_ssm``): at a
    shared site the shared block runs first, over its own KV cache
    ``shared_k[site]`` / ``shared_v[site]`` (site = the sites before it);
    then the Mamba block, whose new state is written into the cache's
    layer row in place.  With a cache and S > 1 (or ``n_valid``) the
    blocks run in prefill-commit mode."""
    site = 0
    for i, (layer, shared_here) in enumerate(zip(model.layers,
                                                 shared_sites(cfg))):
        if shared_here:
            cache_kv = (None if cache is None else
                        (cache["shared_k"][site], cache["shared_v"][site]))
            x, _, _ = _remat(cfg, _decoder_block, model.shared_attn, x, cfg,
                             positions=positions, is_local=False,
                             cache_kv=cache_kv, cache_pos=cache_pos)
            site += 1
        state = (None if cache is None else
                 {name: cache[key][i] for key, name in SSM_STATE.items()})
        x, new_state = _remat(cfg, _ssm_block, layer, x, cfg,
                              ssm_state=state, n_valid=n_valid)
        if cache is not None:
            for key, name in SSM_STATE.items():
                cache[key][i].copy_(new_state[name])
    return x


def _local_flags(cfg: ModelConfig) -> list[bool]:
    """Which layers use the sliding window (gemma2: even)."""
    if cfg.layer_pattern == "local_global" and cfg.sliding_window:
        return [i % 2 == 0 for i in range(cfg.n_layers)]
    return [bool(cfg.sliding_window)] * cfg.n_layers


def _check_inputs(cfg: ModelConfig, *, cache, frontend_embeds,
                  encoder_frames, memory) -> None:
    """Refuse what the JAX package's ``apply_model`` would silently drop or
    fail on without saying why."""
    if frontend_embeds is not None and cache is not None:
        raise ValueError(
            "frontend_embeds are spliced ahead of the text of a cache-less "
            "forward only (prefill_step); decode is text-only")
    if not cfg.is_encoder_decoder:
        if encoder_frames is not None or memory is not None:
            raise ValueError(
                f"{cfg.name} is not an encoder-decoder: it takes no "
                "encoder_frames or memory")
        return
    if encoder_frames is not None and memory is not None:
        raise ValueError("pass encoder_frames or their encoded memory, not "
                         "both")
    if cache is not None and memory is None:
        raise ValueError(
            f"{cfg.name}: a cached (decode or prefill) call needs memory= "
            "(encode(model, frames, cfg)): without it the decoder would run "
            "with no cross-attention")
    if cache is None and memory is None and encoder_frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                         "encoder_frames or memory")


def encode(model: Model, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (B, T,
    D): frames in the activation dtype plus sinusoidal positions, then per
    layer norm → non-causal self-attention → residual, norm → FFN →
    residual (no residual multiplier, no post-norms), then the final
    norm.  Returns the memory (B, T, D)."""
    enc = model.encoder
    if enc is None:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames.to(cfg.activation_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[None]
    for layer in enc.layers:
        x = _remat(cfg, _encoder_block, layer, x, cfg, positions)
    return apply_norm(enc.final_norm, x, cfg)


def _encoder_block(layer: DecoderBlock, x, cfg: ModelConfig, positions):
    h = apply_norm(layer.norm_attn, x, cfg)
    a_out, _ = apply_attention(layer.attn, h, cfg, positions=positions,
                               causal=False)
    x = x + a_out
    h = apply_norm(layer.norm_ffn, x, cfg)
    return x + apply_ffn(layer.ffn, h, cfg)


def apply_model(model: Model, tokens: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None,
                cache_pos: torch.Tensor | int | None = None,
                frontend_embeds: torch.Tensor | None = None,
                encoder_frames: torch.Tensor | None = None,
                memory: torch.Tensor | None = None,
                n_valid: torch.Tensor | None = None):
    """Returns (logits f32 (B, S, V), cache, aux); ``aux`` holds the
    load-balance loss summed over the layers (0 for a dense model).

    tokens: (B, S) int decoder tokens.  ``cache``/``cache_pos``: the dense,
    paged or SSM / hybrid decode cache (updated in place, and returned)
    and the write position — a scalar (batch-synchronous, made a (B,)
    vector here) or a (B,) int vector of per-sequence positions.  A paged
    or SSM cache comes back with ``seq_lens = cache_pos + S``.  DistilBERT
    runs causally here, as in the JAX package.

    ``frontend_embeds`` (B, P, D) (the vision family's patches; cache-less
    only) are spliced ahead of the token embeddings before positions are
    formed: the logits cover P + S positions and the text starts at
    position P.  ``encoder_frames`` (B, T, D) (encoder-decoder, cache-less)
    are encoded here; ``memory`` (B, T, D) is their encoding made
    beforehand (``encode``), which every cached call of an encoder-decoder
    needs.  Every decoder layer cross-attends to it.

    ``n_valid`` (B,) int marks how many of the S tokens each row
    commits.  On an SSM / hybrid cache the recurrent state advances by
    exactly that many (prefill of right-padded prompts).  On a paged cache
    it is the speculative verify mode: the other rows write to the
    allocator's scratch page and attend to nothing, which needs a cache
    that carries the allocator.  Either cache comes back with
    ``seq_lens = cache_pos + n_valid``.
    """
    check_supported(cfg)
    _check_inputs(cfg, cache=cache, frontend_embeds=frontend_embeds,
                  encoder_frames=encoder_frames, memory=memory)
    mesh = getattr(model, "mesh", None)
    sharded = mesh is not None and mesh.size > 1
    # the cache's resolved policy (serving/cache.py): "heads", "pages", or
    # None on a cache built without a mesh
    kv_shard = cache.get("kv_shard") if cache is not None else None
    if sharded:
        check_mesh_supported(cfg)
        if frontend_embeds is not None or cache is None:
            raise NotImplementedError(
                "under a mesh the forward serves a cache (prefill and "
                "decode); a cache-less forward (prefill_step, K5, "
                "frontend_embeds) is ROADMAP queue 1, item 13")
    if sharded != (kv_shard is not None):
        raise ValueError(
            f"a model on {mesh.size if sharded else 1} rank(s) with a cache "
            f"split by {kv_shard}: build the cache with CacheConfig(mesh=) "
            "of the model's mesh (bridge.shard_model)")
    paged = cache is not None and "k_pages" in cache
    ssm_cache = cache is not None and "ssm_h" in cache
    if n_valid is not None and not ssm_cache:
        if not paged:
            raise NotImplementedError(
                "n_valid needs the paged cache layout (speculative verify) "
                "or an SSM / hybrid cache")
        from repro_torch.serving.allocator import require_allocator
        require_allocator(cache, "apply_model(n_valid=)")
    x = embed_tokens(model.embed, tokens, cfg)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
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

    if cfg.is_encoder_decoder and memory is None:
        memory = encode(model, encoder_frames, cfg)

    lb = torch.zeros((), device=dev)
    if is_ssm_family(cfg):
        x = _ssm_stack(model, x, cfg, positions=positions, cache=cache,
                       cache_pos=cache_pos, n_valid=n_valid)
    else:
        # each layer's slice of the cache: dense k/v, or the paged pools
        # (and the int8 layout's scale pools, which travel with their pages)
        kv_keys = [key for key in ("k", "v", "k_pages", "v_pages",
                                   "k_scales", "v_scales")
                   if cache is not None and key in cache]
        page_table = cache["page_table"] if paged else None
        for i, (layer, flag) in enumerate(zip(model.layers,
                                              _local_flags(cfg))):
            cache_kv = tuple(cache[key][i] for key in kv_keys) or None
            x, _, aux = _remat(cfg, _decoder_block, layer, x, cfg,
                               positions=positions, is_local=flag,
                               cache_kv=cache_kv, cache_pos=cache_pos,
                               page_table=page_table, n_new=n_valid,
                               memory=memory, kv_shard=kv_shard)
            if "load_balance_loss" in aux:
                lb = lb + aux["load_balance_loss"]
    if paged or ssm_cache:
        cache["seq_lens"] = (cache_pos + (s if n_valid is None
                                          else n_valid)).to(torch.int32)

    x = apply_norm(model.final_norm, x, cfg)
    logits = unembed(model.embed, x, cfg, model.lm_head)
    return logits, cache, {"load_balance_loss": lb}
