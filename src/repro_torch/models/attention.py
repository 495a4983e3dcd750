"""Attention: MHA/GQA/MQA with RoPE variants, sliding window, softcap,
QK-norm, cross-attention, a dense or paged KV cache, and blockwise
(flash-style) execution.

The Q/K/V projections — the paper's target bottleneck — route through
``core.qkv_fusion.apply_fused_qkv`` (the persistent-A / update_A mechanism)
or ``core.quantized_linear.apply_linear`` under the config's ``quant_proj``
mode.  On the dense cache, and without a cache below
``cfg.blockwise_attn_threshold``, scores are computed in f32 over the whole
(S, T) block (``_attend_dense``); on the paged cache every step goes
through the paged flash-decode kernel K4 (``_attend_paged``).  A cache-less
forward of ``s >= cfg.blockwise_attn_threshold`` never materializes the
(S, T) scores: ``cfg.attn_impl`` ``auto`` or ``flash`` runs it through
``flash_attention`` (the block-sparse kernel K5 on the card, which masks
gemma2's sliding window in-kernel and skips the KV blocks the window
hides), ``jnp`` through the double-chunked online softmax
``_attend_blockwise`` in plain PyTorch, on the CPU only: on the card that
path raises, so no config value takes a long prompt past K5.  Sequence
lengths need not divide any tile or chunk size.  The encoder's
bidirectional self-attention (``causal=False``) takes the same routes
without the causal mask.  Cross-attention (``memory=``: Q from x, K and V
from the encoder's output, no rope, no cache) always attends densely and
non-causally, whatever the memory's length, as in the JAX package; it
recomputes K and V from ``memory`` at every call.

Over a serving mesh (``bridge.shard_model``; ``docs/DESIGN.md`` §3) a
rank's Q/K/V projections give its columns, and the cache it was handed
says the policy (its ``kv_shard``, passed down as ``kv_shard=``).  ``heads`` (its pools hold K/m KV heads): tensor-parallel
decode, each rank running K4 over its KV heads, with each q head's group,
and the whole page table, its page walk split as the unsharded launch's
(``split_heads``), so its heads are bitwise mesh 1's.  ``pages`` (its pools
hold all heads of P/m pages): Q, K and V are gathered whole, the new rows
scatter only into pages the rank owns, and each rank walks only those
pages, combining with the others through a partial softmax against the
global row max (``_paged_attend_split``, plain PyTorch on either device,
as the JAX package's combine is plain jnp whatever its kernel mode).  The
output projection is row-parallel.  The paged and dense caches serve
under a mesh (the dense one by heads only); a cache-less forward (K5),
cross-attention and the verify mode raise (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.qkv_fusion import apply_fused_qkv
from repro_torch.core.quantization import quantize_kv
from repro_torch.core.quantized_linear import (Linear, apply_linear,
                                               apply_linears, init_linear)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     paged_decode_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Norm, apply_norm, apply_rope,
                                       init_norm, softcap)

NEG_INF = -2.3819763e38  # finite min-bf16-safe mask value

# paged steps of up to this many new tokens run K4 as one q block; longer
# cache-writing steps (prefill) run it in PAGED_PREFILL_CHUNK_Q-row blocks,
# each walking only the pages its own causal horizon exposes
PAGED_FLASH_MAX_Q = 8
PAGED_PREFILL_CHUNK_Q = 128


def _flash_engine_live(cfg: ModelConfig) -> bool:
    """Does ``cfg.attn_impl`` select the flash engine (``flash_attention``:
    K5 on the card, its plain version on the CPU)?  ``auto`` does: the
    port's kernels are always live."""
    return cfg.attn_impl in ("auto", "flash")


def _run_windowed(fn, cfg: ModelConfig, is_local: bool):
    """``fn(window)`` with the layer's window: the config's sliding window on
    a local layer, none on a global one or without a sliding window."""
    if cfg.sliding_window is None:
        return fn(None)
    return fn(cfg.sliding_window if is_local else None)


class Attention(nn.Module):
    """Q/K/V/O projections, plus per-head q/k norms under ``qk_norm``;
    ``mesh``, the serving mesh of a rank's shard (``bridge.shard_model``),
    else None."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 q_norm: Norm | None = None, k_norm: Norm | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm = q_norm
        self.k_norm = k_norm
        self.mesh = None


def init_attention(generator: torch.Generator, cfg: ModelConfig) -> Attention:
    wq = init_linear(generator, cfg.d_model, cfg.q_dim, use_bias=cfg.qkv_bias)
    wk = init_linear(generator, cfg.d_model, cfg.kv_dim, use_bias=cfg.qkv_bias)
    wv = init_linear(generator, cfg.d_model, cfg.kv_dim, use_bias=cfg.qkv_bias)
    wo = init_linear(generator, cfg.q_dim, cfg.d_model,
                     scale=(cfg.q_dim ** -0.5) / max(cfg.n_layers, 1) ** 0.5)
    q_norm = k_norm = None
    if cfg.qk_norm:
        q_norm = init_norm(cfg, cfg.head_dim, device=generator.device)
        k_norm = init_norm(cfg, cfg.head_dim, device=generator.device)
    return Attention(wq, wk, wv, wo, q_norm, k_norm)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _mask_bias(q_pos, k_pos, *, window, is_local: bool,
               causal: bool = True) -> torch.Tensor:
    """(…, S, T) additive causal (and sliding-window) bias."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed &= kp <= qp
    if window is not None and is_local:
        allowed &= kp > qp - window
    return torch.where(allowed, 0.0, NEG_INF).float()


def _attend_dense(q, k, v, q_pos, k_pos, *, scale, cap, window, is_local,
                  causal: bool = True):
    """q (B,S,K,G,hd); k,v (B,T,K,hd) → (B,S,K,G,hd).  Scores in f32.

    ``q_pos`` may be (S,) (batch-synchronous) or (B, S) (per-sequence
    positions — mixed-length batches); it is aligned to the (B,K,G,S,T)
    score block so the mask broadcasts per sequence.  A mask that hides
    nothing (non-causal, no window on this layer) is not built: its bias
    is all zeros.
    """
    if q_pos.dim() == 2:
        q_pos = q_pos[:, None, None, :]        # (B,1,1,S) → bias (B,1,1,S,T)
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    s = softcap(s, cap)
    if causal or (window is not None and is_local):
        s = s + _mask_bias(q_pos, k_pos, window=window, is_local=is_local,
                           causal=causal)
    p = torch.softmax(s, dim=-1)
    # probabilities rounded to v's dtype, products summed in f32
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def _attend_blockwise(q, k, v, q_offset, *, scale, cap, causal, window,
                      is_local: bool, q_chunk, kv_chunk):
    """Double-chunked online-softmax attention (flash-style, plain PyTorch).

    q (B,S,K,G,hd); k,v (B,T,K,hd) → (B,S,K,G,hd) in q's dtype.  Never
    holds more than (B,K,G,q_chunk,kv_chunk) scores, in f32; the math is
    softmax attention's.  The last chunk of q or KV may be partial: it is
    sliced shorter, where the JAX package pads it and masks the padding.
    CPU tensors only: on the card the blockwise path is K5.
    """
    if q.device.type != "cpu":
        raise ValueError(
            f"attn_impl='jnp' runs plain PyTorch on the CPU only, got "
            f"{q.device}; on the card use 'auto' or 'flash' (kernel K5)")
    b, s_len, kh, g, hd = q.shape
    t_len = k.shape[1]
    q_chunk = min(q_chunk, s_len)
    kv_chunk = min(kv_chunk, t_len)
    dev = q.device
    out = torch.empty_like(q)
    for q0 in range(0, s_len, q_chunk):
        qc = q[:, q0:q0 + q_chunk].float()
        n = qc.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        acc = torch.zeros((b, kh, g, n, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, kh, g, n), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, n), dtype=torch.float32, device=dev)
        for k0 in range(0, t_len, kv_chunk):
            kc = k[:, k0:k0 + kv_chunk].float()
            vc = v[:, k0:k0 + kv_chunk].float()
            k_pos = k0 + torch.arange(kc.shape[1], device=dev)
            s = torch.einsum("bskgh,btkh->bkgst", qc, kc) * scale
            s = softcap(s, cap)
            s = s + _mask_bias(q_pos, k_pos, window=window,
                               is_local=is_local, causal=causal)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkh->bkgsh", p, vc)
            m = m_new
        o = acc / torch.clamp(l, min=1e-37)[..., None]
        out[:, q0:q0 + n] = o.to(q.dtype).permute(0, 3, 1, 2, 4)
    return out


def _attend_paged(params: Attention, q, k, v, cfg: ModelConfig, *, cache,
                  cache_pos, page_table, is_local: bool, scale, b, s,
                  n_new=None, mesh=None, by=None):
    """Paged-cache step: scatter the new K/V into their pages, attend
    through K4, project.

    q (B,S,H,hd), k/v (B,S,K,hd), already rope'd.  ``cache`` is one
    layer's (k_pages, v_pages), each (P, page, K, hd), or (k_pages,
    v_pages, k_scales, v_scales) for int8 pools with (P, page, K) f32
    scales; the new rows are written in place (int8 pools get their
    ``quantize_kv`` values and scales through the same indices).
    ``cache_pos`` (B,) are the per-sequence lengths before the write.

    ``n_new`` (B,) int is the speculative verify mode: of the S rows only
    rows ``r < n_new[b]`` are live; dead rows, and rows whose position
    falls past the table's reach, write to the allocator's scratch page
    (the logical page is clipped into the table before it is looked up)
    and read back 0 from K4's verify launch.

    ``by`` is the mesh policy (``"heads"`` or ``"pages"``, module
    docstring) of a sharded cache, else None.
    """
    quant = len(cache) == 4
    ck, cv = cache[0], cache[1]
    page = ck.shape[1]
    rows = torch.arange(s, device=q.device)
    tok_pos = cache_pos[:, None] + rows                              # (B, S)
    if n_new is None:
        pidx = torch.gather(page_table, 1, tok_pos // page).long()
        slot = tok_pos % page
    else:
        from repro_torch.serving.cache import page_slots
        pidx, slot = page_slots(page_table, tok_pos,
                                rows[None, :] < n_new[:, None], page)
    if by == "pages":
        # global page ids → this rank's slab; the pages it does not own
        # are written by their owners
        per = ck.shape[0]
        local = pidx - mesh.rank * per
        mine = (local >= 0) & (local < per)
        pidx, slot = local[mine], slot[mine]
        k, v = k[mine], v[mine]
    cks = cvs = None
    if quant:
        cks, cvs = cache[2], cache[3]
        kq, k_sc = quantize_kv(k)             # (B,S,K,hd) int8, (B,S,K) f32
        vq, v_sc = quantize_kv(v)
        ck[pidx, slot] = kq
        cv[pidx, slot] = vq
        cks[pidx, slot] = k_sc
        cvs[pidx, slot] = v_sc
    else:
        ck[pidx, slot] = k.to(ck.dtype)
        cv[pidx, slot] = v.to(cv.dtype)
    if by == "pages":
        o = _paged_attend_split(q, tok_pos, page_table, tuple(cache), cfg,
                                scale=scale, is_local=is_local, mesh=mesh)
        return _project_out(params, o.reshape(b, s, cfg.q_dim), cfg,
                            whole=True), tuple(cache)
    lengths = (cache_pos + (s if n_new is None else n_new)).to(torch.int32)
    q_chunk = None if s <= PAGED_FLASH_MAX_Q else PAGED_PREFILL_CHUNK_Q
    window = cfg.sliding_window if is_local else None
    # q is a view of the projection when Q/K/V come from one matmul
    o = paged_decode_attention(q.contiguous(), ck, cv, page_table, lengths,
                               scale=scale,
                               window=window, softcap=cfg.attn_logit_softcap,
                               q_chunk=q_chunk, k_scales=cks, v_scales=cvs,
                               new_lens=None if n_new is None
                               else n_new.to(torch.int32),
                               split_heads=cfg.n_kv_heads)
    o = o.reshape(b, s, -1)
    return _project_out(params, o, cfg), tuple(cache)


def _paged_attend_split(q, tok_pos, page_table, pools, cfg: ModelConfig, *,
                        scale, is_local: bool, mesh):
    """Split-KV paged attention over this rank's slab of the pool.

    q (B, S, H, hd) whole; ``pools`` this rank's (k_pages, v_pages[,
    k_scales, v_scales]), each (P/m, page, K, ...).  The rank walks the
    table entries naming its own pages (the others gather page 0 of its
    slab and are masked), and the partial softmaxes combine exactly: the
    global row max by ``pmax``, then ``psum`` of the normaliser and of
    the weighted V (flash attention's identity across ranks; only
    (B, H, S)-sized partials cross the mesh, never KV).  Returns
    (B, S, H, hd) in q's dtype, the same bits on every rank."""
    from repro_torch.kernels.flash_attention.ref import (
        dequantize_gathered, paged_gather, paged_gather_scales)
    quant = len(pools) == 4
    per, page = pools[0].shape[:2]
    b, s, h, hd = q.shape
    kh = cfg.n_kv_heads
    g = h // kh
    local = page_table.long() - mesh.rank * per
    owned = (local >= 0) & (local < per)                   # (B, max_pages)
    local = torch.where(owned, local, 0)
    kd = paged_gather(pools[0], local)                     # (B, T, K, hd)
    vd = paged_gather(pools[1], local)
    if quant:
        kd = dequantize_gathered(kd, paged_gather_scales(pools[2], local))
        vd = dequantize_gathered(vd, paged_gather_scales(pools[3], local))
    t_len = kd.shape[1]
    own_tok = owned.repeat_interleave(page, dim=1)[:, None, None, None, :]
    sc = torch.einsum("bskgh,btkh->bkgst", q.reshape(b, s, kh, g, hd).float(),
                      kd.float()) * scale
    sc = softcap(sc, cfg.attn_logit_softcap)
    sc = sc + _mask_bias(tok_pos[:, None, None, :],
                         torch.arange(t_len, device=q.device),
                         window=cfg.sliding_window, is_local=is_local)
    sc = torch.where(own_tok, sc, NEG_INF)
    # the global row max is finite: the diagonal was just written to a page
    # some rank owns
    m = mesh.pmax(torch.amax(sc, dim=-1))                  # (B, K, G, S)
    p = torch.where(own_tok, torch.exp(sc - m[..., None]), 0.0)
    # the weighted V and the normaliser summed in one collective
    both = mesh.psum(torch.cat([torch.einsum("bkgst,btkh->bkgsh", p,
                                             vd.float()),
                                p.sum(dim=-1)[..., None]], dim=-1))
    acc, l = both[..., :hd], both[..., hd]
    o = (acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def _project_out(params: Attention, o, cfg: ModelConfig, *,
                 whole: bool = False):
    """``wo`` over the attention output (B, S, ·).  ``whole``: ``o`` holds
    every head (the ``pages`` policy), of which a row-parallel ``wo``
    takes this rank's columns; else ``o`` is the rank's heads already."""
    wo = params.wo
    if wo.shard == "row" and whole:
        lo, hi = wo.mesh.shard_bounds(cfg.q_dim)
        o = o[..., lo:hi]
    return apply_linear(wo, o, mode=cfg.quant_proj)


def apply_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    is_local: bool = False,
                    causal: bool = True,
                    memory: torch.Tensor | None = None,
                    cache: tuple | None = None,
                    cache_pos: torch.Tensor | None = None,
                    page_table: torch.Tensor | None = None,
                    n_new: torch.Tensor | None = None,
                    kv_shard: str | None = None):
    """Self-attention over x (B, S, D), causal or (``causal=False``, the
    encoder's) bidirectional, without a cache or with a dense or paged one;
    or cross-attention from x to ``memory`` (B, T, D).

    Without a cache, ``s >= cfg.blockwise_attn_threshold`` takes the
    blockwise path: ``flash_attention`` (K5) or, for ``attn_impl="jnp"`` on
    the CPU, ``_attend_blockwise``, with the sliding window on local
    layers.

    Cross-attention projects Q from x and K, V from ``memory`` (one K1 of
    the memory rows serves both under w8a8), applies no rope and attends
    densely over all T memory rows, non-causally and with no window; it
    takes no cache.

    With ``cache`` = (k, v), each (B, S_max, K, hd), the new keys and values
    are written **in place** into the cache tensors at ``cache_pos``, a (B,)
    int vector of per-sequence write positions (mixed-length batches), and
    attention runs over the whole cache with per-sequence causal masking.
    With ``page_table`` the cache is one layer's page pools
    (``_attend_paged``; ``n_new`` selects its verify mode).  ``kv_shard``
    is the cache's mesh policy (``"heads"`` / ``"pages"``, module
    docstring; None unsharded).

    Returns (y, the layer's cache tuple or None).
    """
    if memory is not None and cache is not None:
        raise ValueError("cross-attention (memory=) takes no cache: K and V "
                         "come from the memory at every call")
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.head_dim
    mesh = params.mesh
    by = _mesh_policy(mesh, kv_shard, cache=cache, memory=memory,
                      n_new=n_new)
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    if memory is not None:
        q = apply_linear(params.wq, x, mode=cfg.quant_proj)
        k, v = apply_linears((params.wk, params.wv), memory,
                             mode=cfg.quant_proj)
    elif cfg.fuse_qkv:
        q, k, v = apply_fused_qkv(params.wq, params.wk, params.wv, x,
                                  mode=cfg.quant_proj)
    else:
        q = apply_linear(params.wq, x, mode=cfg.quant_proj)
        k = apply_linear(params.wk, x, mode=cfg.quant_proj)
        v = apply_linear(params.wv, x, mode=cfg.quant_proj)

    if by == "pages":
        # each rank computed its columns; every rank attends every head
        q, k, v = _whole_columns(mesh, (params.wq, params.wk, params.wv),
                                 (q, k, v))
    # a tensor-parallel rank holds its own heads: K/m KV heads, g q heads
    # each
    kh = k.shape[-1] // hd
    q = _split_heads(q, kh * g, hd)
    k = _split_heads(k, kh, hd)
    v = _split_heads(v, kh, hd)

    if cfg.qk_norm:
        q = apply_norm(params.q_norm, q, cfg)
        k = apply_norm(params.k_norm, k, cfg)

    if memory is not None:
        o = _attend_dense(q.reshape(b, s, kh, g, hd), k, v, positions,
                          torch.arange(k.shape[1], device=x.device),
                          scale=scale, cap=cfg.attn_logit_softcap,
                          window=None, is_local=False, causal=False)
        y = apply_linear(params.wo, o.reshape(b, s, cfg.q_dim),
                         mode=cfg.quant_proj)
        return y, None

    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)

    if cache is not None and page_table is not None:
        return _attend_paged(params, q, k, v, cfg, cache=cache,
                             cache_pos=cache_pos, page_table=page_table,
                             is_local=is_local, scale=scale, b=b, s=s,
                             n_new=n_new, mesh=mesh, by=by)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        bidx = torch.arange(b, device=x.device)[:, None]
        tok_pos = cache_pos[:, None] + torch.arange(s, device=x.device)
        ck[bidx, tok_pos] = k.to(ck.dtype)
        cv[bidx, tok_pos] = v.to(cv.dtype)
        new_cache = (ck, cv)
        k, v = ck, cv
        k_pos = torch.arange(k.shape[1], device=x.device)
    else:
        k_pos = positions

    use_blockwise = cache is None and s >= cfg.blockwise_attn_threshold
    if use_blockwise and _flash_engine_live(cfg):
        # q, k, v may be views of one concatenated projection
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()

        def _flash(window):
            return flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window,
                                   softcap=cfg.attn_logit_softcap)

        o = _run_windowed(_flash, cfg, is_local)
    elif use_blockwise:
        o = _attend_blockwise(
            q.reshape(b, s, kh, g, hd), k, v, 0, scale=scale,
            cap=cfg.attn_logit_softcap, causal=causal,
            window=cfg.sliding_window, is_local=is_local,
            q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv)
    else:
        o = _attend_dense(q.reshape(b, s, kh, g, hd), k, v, positions, k_pos,
                          scale=scale, cap=cfg.attn_logit_softcap,
                          window=cfg.sliding_window, is_local=is_local,
                          causal=causal)
    return _project_out(params, o.reshape(b, s, -1), cfg), new_cache


def _whole_columns(mesh, projections, outputs):
    """``outputs`` (…, n_i) made whole: those of a column-parallel
    projection gathered over the mesh in rank order along the last dim,
    side by side in one collective; the others are whole already."""
    split = [i for i, p in enumerate(projections) if p.shard == "column"]
    out = list(outputs)
    if not split:
        return out
    every = mesh.all_gather(torch.cat([outputs[i] for i in split],
                                      dim=-1)[None], dim=0)
    lo = 0
    for i in split:
        w = outputs[i].shape[-1]
        piece = every[..., lo:lo + w]                 # (ranks, …, w)
        out[i] = piece.movedim(0, -2).reshape(*piece.shape[1:-1], -1)
        lo += w
    return out


def _mesh_policy(mesh, kv_shard, *, cache, memory, n_new):
    """None without a mesh of more than one rank, else the cache's policy
    ``kv_shard``.  Raises on what does not run over a mesh."""
    if mesh is None or mesh.size == 1:
        return None
    if memory is not None:
        raise NotImplementedError(
            "cross-attention (memory=) under a mesh: ROADMAP queue 1, "
            "item 13")
    if cache is None:
        raise NotImplementedError(
            "a cache-less forward (prefill_step, K5) under a mesh: ROADMAP "
            "queue 1, item 13")
    if n_new is not None:
        raise NotImplementedError(
            "speculative verify (n_new) is not supported on the sharded "
            "paged decode path: the Scheduler degrades to 1-token decode "
            "under a mesh of more than one rank")
    if kv_shard not in ("heads", "pages"):
        raise ValueError(f"a mesh of {mesh.size} ranks with a cache whose "
                         f"policy is {kv_shard!r}: build it with "
                         "CacheConfig(mesh=)")
    return kv_shard
