"""Plain PyTorch versions of the flash-attention kernels: dense softmax
attention (K5, ``attention_ref``), its log-sum-exps and step-by-step
backward (K5's backward kernels, ``attention_lse_ref`` and
``attention_bwd_ref``) and paged decode (K4,
``paged_decode_attention_ref``).

Each computes its kernel's function in one f32 softmax over the whole
score block: the CPU runs them, and ``chip_smoke.py`` holds the kernels
against them on the card.  GQA-native: the ``H // KH`` query heads of a KV
head share it by reshape, not repeat.  ``paged_decode_attention_ref``
gathers the page pool back into a dense cache first.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def _masks(s_len: int, t_len: int, causal: bool, window: int | None, dev
           ) -> torch.Tensor | None:
    """(S, T) bool: key t visible to query s (None: every key)."""
    if not causal and window is None:
        return None
    sq = torch.arange(s_len, device=dev)[:, None]
    tk = torch.arange(t_len, device=dev)[None, :]
    mask = torch.ones((s_len, t_len), dtype=torch.bool, device=dev)
    if causal:
        mask &= tk <= sq
    if window is not None:
        mask &= tk > sq - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float | None = None, causal: bool = True,
                  window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KH, D) → (B, S, H, D) in v's dtype: the
    ``flash_attention`` wrapper's layout.

    f32 scores; key t is visible to query s where ``t <= s`` (causal) and
    ``t > s - window``; softcap through tanh; a fully masked row gives 0.
    The probabilities ``p / l`` are rounded to v's dtype and their products
    with v summed in f32.  Where autograd needs no gradient the score block
    is updated in place (it is the whole (B, H, S, T) f32 block, the
    largest tensor here); otherwise the same operations run out of place,
    so that autograd differentiates them (the CPU's backward of K5).
    """
    b, s_len, h, d = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    inplace = not (torch.is_grad_enabled()
                   and any(x.requires_grad for x in (q, k, v)))

    def op(x, name, *args):
        return getattr(x, name + "_" if inplace else name)(*args)

    qg = q.reshape(b, s_len, kh, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s = op(s, "mul", scale)
    if softcap is not None:
        # a tensor divisor: on CUDA a Python scalar one becomes a multiply
        # by its reciprocal, not the IEEE quotient the kernel computes
        s = op(op(op(s, "div", torch.full((), softcap, device=s.device)),
                  "tanh"), "mul", softcap)
    mask = _masks(s_len, t_len, causal, window, q.device)
    if mask is not None:
        s = op(s, "masked_fill", ~mask, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    s = op(op(s, "sub", m), "exp")                      # s now holds p
    if mask is not None:
        s = op(s, "masked_fill", ~mask, 0.0)
    l = torch.clamp(s.sum(dim=-1, keepdim=True), min=1e-37)
    p = op(s, "div", l).to(v.dtype)
    del s
    o = torch.einsum("bkgst,btkd->bskgd", p.float(), v.float())
    return o.to(v.dtype).reshape(b, s_len, h, d)


def _scores(q, k, scale, softcap):
    """(B, KH, G, S, T) f32 scores of q (B, S, H, D) over k (B, T, KH, D)
    as K5 forms them, and the softcap's derivative (None without one)."""
    b, s_len, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s_len, kh, h // kh, d).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap is None:
        return s, None
    th = torch.tanh(s / torch.full((), softcap, device=s.device))
    return softcap * th, 1.0 - th * th


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      scale: float | None = None, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None) -> torch.Tensor:
    """Each row's log-sum-exp m + log(l) over its visible keys, (B, H, S)
    f32, as K5's forward writes it for the backward; +inf for a row that
    sees no key."""
    b, s_len, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    s, _ = _scores(q, k, scale, softcap)
    mask = _masks(s_len, k.shape[1], causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, math.inf))
    return lse[..., 0].reshape(b, h, s_len)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, out: torch.Tensor | None = None,
                      scale: float | None = None, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None):
    """dQ, dK, dV of ``attention_ref`` given the output's gradient
    ``dout`` (B, S, H, D), step by step in f32 as K5's backward kernels
    compute them: P = exp(s - lse) on the visible keys, D = rowsum(dO * O)
    with ``out`` (default: ``attention_ref``'s output in f32, as K5's
    forward keeps it for the backward), dS = P (dO V^T - D), dA = dS times the softcap's derivative
    1 - tanh^2 and the scale, dQ = dA K, dK = dA^T Q and dV = P^T dO summed
    over each KV head's query heads.  A row that sees no key gets 0.  Each
    gradient comes back in its input's dtype."""
    b, s_len, h, d = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    opts = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if out is None:
        out = attention_ref(q.float(), k.float(), v.float(), **opts)
    s, dcap = _scores(q, k, scale, softcap)
    lse = attention_lse_ref(q, k, **opts).reshape(b, kh, g, s_len, 1)
    mask = _masks(s_len, t_len, causal, window, q.device)
    p = torch.exp(s - lse)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dog = dout.reshape(b, s_len, kh, g, d).float()
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    delta = torch.einsum("bskgd,bskgd->bkgs", dog,
                         out.reshape(b, s_len, kh, g, d).float())
    da = p * (dp - delta[..., None])
    if dcap is not None:
        da = da * dcap
    da = da * scale
    qg = q.reshape(b, s_len, kh, g, d).float()
    dq = torch.einsum("bkgst,btkd->bskgd", da, k.float()).reshape(b, s_len,
                                                                   h, d)
    dk = torch.einsum("bkgst,bskgd->btkd", da, qg)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages (P, page, KH, D); page_table (B, max_pages) int32 →
    (B, max_pages·page, KH, D), each sequence in logical token order."""
    b, max_pages = page_table.shape
    _, page, kh, d = pages.shape
    return pages[page_table.long()].reshape(b, max_pages * page, kh, d)


def paged_gather_scales(scales: torch.Tensor,
                        page_table: torch.Tensor) -> torch.Tensor:
    """scales (P, page, KH) f32; page_table (B, max_pages) int32 →
    (B, max_pages·page, KH), token order matching ``paged_gather``."""
    b, max_pages = page_table.shape
    _, page, kh = scales.shape
    return scales[page_table.long()].reshape(b, max_pages * page, kh)


def dequantize_gathered(values: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """(B, T, KH, D) int8 values × (B, T, KH) scales → f32: the dequant
    the kernel does on load (``values.f32 * scale``)."""
    return values.float() * scales[..., None]


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               scale: float | None = None,
                               window: int | None = None,
                               softcap: float | None = None,
                               q_chunk: int | None = None,
                               k_scales: torch.Tensor | None = None,
                               v_scales: torch.Tensor | None = None,
                               new_lens: torch.Tensor | None = None,
                               split_heads: int | None = None
                               ) -> torch.Tensor:
    """Dense oracle over a paged cache, with the wrapper's interface.

    q (B, q_len, H, D); pools (P, page, KH, D); lengths (B,) int32 is the
    context *including* the q_len new rows → (B, q_len, H, D) in q's
    dtype.  Row r of sequence b sits at position ``lengths[b] - q_len +
    r``; causality, the window and the uncommitted tail are masked against
    it, and a fully masked row gives 0.  ``k_scales``/``v_scales``
    (P, page, KH) f32 select int8 pools, dequantized row by row.
    ``q_chunk`` and ``split_heads`` are the kernel's blocking and change
    nothing here.

    ``new_lens`` (B,) int32 is the verify mode: row r of sequence b is
    live iff ``r < new_lens[b]``, at position ``lengths[b] - new_lens[b]
    + r``; dead rows are fully masked (0 output).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, qs, h, d = q.shape
    kh = k_pages.shape[2]
    g = h // kh
    k = paged_gather(k_pages, page_table)           # (B, T, KH, D)
    v = paged_gather(v_pages, page_table)
    if k_scales is not None:
        k = dequantize_gathered(k, paged_gather_scales(k_scales, page_table))
    if v_scales is not None:
        v = dequantize_gathered(v, paged_gather_scales(v_scales, page_table))
    t_len = k.shape[1]
    qg = q.transpose(1, 2).reshape(b, kh, g, qs, d)
    s = torch.einsum("bkgsd,btkd->bkgst", qg.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(qs, device=q.device)
    n_live = (torch.full_like(lengths, qs) if new_lens is None
              else new_lens).long()
    q_pos = lengths.long()[:, None] - n_live[:, None] + rows[None, :]  # (B, qs)
    k_pos = torch.arange(t_len, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]            # (B, qs, T)
    if new_lens is not None:
        # rows past the live count belong to no token
        mask &= (rows[None, :] < n_live[:, None])[:, :, None]
    if window is not None:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
    mask = mask[:, None, None]                                  # (B,1,1,qs,T)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    # probabilities normalised, rounded to v's dtype, products summed in f32
    o = torch.einsum("bkgst,btkd->bkgsd", (p / l).to(v.dtype).float(),
                     v.float())
    return o.to(v.dtype).reshape(b, h, qs, d).transpose(1, 2).to(q.dtype)
