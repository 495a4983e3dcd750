"""Plain PyTorch versions of the flash-attention kernels: dense softmax
attention (K5, ``attention_ref``) and paged decode (K4,
``paged_decode_attention_ref``).

Each computes its kernel's function in one f32 softmax over the whole
score block: the CPU runs them, and ``chip_smoke.py`` holds the kernels
against them on the card.  GQA-native: the ``H // KH`` query heads of a KV
head share it by reshape, not repeat.  ``paged_decode_attention_ref``
gathers the page pool back into a dense cache first.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float | None = None, causal: bool = True,
                  window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KH, D) → (B, S, H, D) in v's dtype: the
    ``flash_attention`` wrapper's layout.

    f32 scores; key t is visible to query s where ``t <= s`` (causal) and
    ``t > s - window``; softcap through tanh; a fully masked row gives 0.
    The probabilities ``p / l`` are rounded to v's dtype and their products
    with v summed in f32.  The score block is updated in place: it is the
    whole (B, H, S, T) f32 block, the largest tensor here.
    """
    b, s_len, h, d = q.shape
    t_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s_len, kh, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    s.mul_(scale)
    if softcap is not None:
        # a tensor divisor: on CUDA a Python scalar one becomes a multiply
        # by its reciprocal, not the IEEE quotient the kernel computes
        s.div_(torch.full((), softcap, device=s.device)).tanh_().mul_(softcap)
    mask = None
    if causal or window is not None:
        sq = torch.arange(s_len, device=q.device)[:, None]
        tk = torch.arange(t_len, device=q.device)[None, :]
        mask = torch.ones((s_len, t_len), dtype=torch.bool, device=q.device)
        if causal:
            mask &= tk <= sq
        if window is not None:
            mask &= tk > sq - window
        s.masked_fill_(~mask, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    s.sub_(m).exp_()                                    # s now holds p
    if mask is not None:
        s.masked_fill_(~mask, 0.0)
    l = torch.clamp(s.sum(dim=-1, keepdim=True), min=1e-37)
    p = s.div_(l).to(v.dtype)
    del s
    o = torch.einsum("bkgst,btkd->bskgd", p.float(), v.float())
    return o.to(v.dtype).reshape(b, s_len, h, d)


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
                               new_lens: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Dense oracle over a paged cache, with the wrapper's interface.

    q (B, q_len, H, D); pools (P, page, KH, D); lengths (B,) int32 is the
    context *including* the q_len new rows → (B, q_len, H, D) in q's
    dtype.  Row r of sequence b sits at position ``lengths[b] - q_len +
    r``; causality, the window and the uncommitted tail are masked against
    it, and a fully masked row gives 0.  ``k_scales``/``v_scales``
    (P, page, KH) f32 select int8 pools, dequantized row by row.
    ``q_chunk`` is the kernel's blocking and changes nothing here.

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
