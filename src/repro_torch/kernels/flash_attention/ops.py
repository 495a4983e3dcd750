"""Wrappers for the flash-attention kernels: the block-sparse prefill
kernel K5 (``flash_attention``, differentiable through its backward
kernels) and paged flash decode K4 (``paged_decode_attention``).  Each
launches its CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors; K4 has no backward and raises under autograd on CUDA."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, needs_grad, no_backward
from repro_torch.kernels.flash_attention import decode as _decode
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "flash_attention_backward",
           "paged_decode_attention"]

_Q_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


def _check(t: torch.Tensor, dtype, shape, dev, what: str,
           fn: str = "paged_decode_attention") -> None:
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != dev:
        raise ValueError(f"{fn}: {what} on {t.device}, q on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Multi-head attention, q (B, S, H, D) over k, v (B, T, KH, D) (GQA:
    H a multiple of KH, each KV head shared by its H // KH query heads,
    never repeated).

    Returns (B, S, H, D) in q's dtype (f32 softmax inside).  ``window``
    masks key t for query s unless ``t > s - window``; with ``causal``,
    also unless ``t <= s``; a row that sees no key gives 0.  ``softcap``
    caps the scores through tanh.  S and T need not be multiples of any
    tile.

    A CUDA tensor launches K5 (``csrc/flash_attention.cu``; f32 or bf16
    q, k and v, contiguous, head_dim <= 128), whose tiles are its own:
    ``kernel.KERNEL_Q_TILE`` q rows by ``kernel.KERNEL_KV_TILE`` KV rows
    (the JAX package's ``q_chunk``/``kv_chunk`` have no counterpart).
    Where autograd needs gradients of q, k or v, the launch also writes the
    rows' log-sum-exps and the call is differentiable: its backward
    launches K5's backward kernels (``csrc/flash_attention_bwd.cu``), one
    call counted in ``backward_launches``.  A CPU tensor runs the plain
    version, ``ref.attention_ref``, which autograd differentiates.
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape != (b, t, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    if dev.type == "cpu":
        return _ref.attention_ref(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap).to(q.dtype)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, got "
                        f"{q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    _check(q, q.dtype, (b, s, h, d), dev, "q", "flash_attention")
    _check(k, q.dtype, (b, t, kh, d), dev, "k", "flash_attention")
    _check(v, q.dtype, (b, t, kh, d), dev, "v", "flash_attention")
    if t < 1:
        raise ValueError("flash_attention kernel needs at least one key")
    opts = (scale, causal, window, softcap)
    if needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, *opts)
    return _flash_forward(q, k, v, *opts, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.backward_launches = 0


def _flash_forward(q, k, v, scale, causal, window, softcap, *, with_lse):
    """One K5 launch: (out, lse, out32).  With ``with_lse`` it also writes
    the rows' log-sum-exps (B, H, S) f32 and, for bf16, ``out32``: out in
    f32 before its rounding (for f32, out itself); else both are None."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = out32 = None
    if with_lse:
        lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        out32 = (torch.empty(q.shape, dtype=torch.float32, device=dev)
                 if bf16 else out)
    fn = _build.library("flash_attention").launch_flash_attention
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None,
                    out32.data_ptr() if with_lse and bf16 else None,
                    b, s, t, h, kh, d, int(causal),
                    window if window is not None else 0, scale,
                    softcap if softcap is not None else 0.0,
                    int(bf16), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    return out, lse, out32


def flash_attention_backward(q, k, v, out32, lse, dout, *, scale,
                             causal=True, window=None, softcap=None):
    """dQ, dK, dV of ``flash_attention`` (CUDA tensors): K5's backward
    kernels (``csrc/flash_attention_bwd.cu``) on the forward's inputs, its
    output in f32 ``out32`` and log-sum-exps ``lse`` (B, H, S), as
    ``_flash_forward(with_lse=True)`` gives them, and the output's gradient
    ``dout``; each gradient in its input's dtype.  The kernels' f32 scratch
    (rowsum(dO * O) and, in bf16 with GQA, each query head's dK and dV
    share) is allocated here, sized by ``kernel.bwd_scratch_floats``.
    Counted in ``flash_attention.backward_launches``."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    dev = q.device
    dout = dout.to(q.dtype).contiguous()
    what = "flash_attention_backward"
    _check(out32, torch.float32, (b, s, h, d), dev, "out32", what)
    _check(dout, q.dtype, (b, s, h, d), dev, "dout", what)
    _check(lse, torch.float32, (b, h, s), dev, "lse", what)
    scratch = torch.empty(_kernel.bwd_scratch_floats(
        b, s, t, h, kh, d, bf16=q.dtype == torch.bfloat16),
        dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    fn = _build.library("flash_attention_bwd").launch_flash_attention_bwd
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, s, t, h, kh, d, int(causal),
                    window if window is not None else 0, scale,
                    softcap if softcap is not None else 0.0,
                    int(q.dtype == torch.bfloat16), dev.index,
                    torch.cuda.current_stream(dev).cuda_stream), what)
    flash_attention.backward_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K5 under autograd: the forward saves q, k, v, the output in f32 and
    the log-sum-exps; the backward runs ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out, lse, out32 = _flash_forward(q, k, v, scale, causal, window,
                                         softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 7
        dq, dk, dv = flash_attention_backward(q, k, v, out32, lse, dout,
                                              **ctx.opts)
        grads = [g if need else None
                 for g, need in zip((dq, dk, dv), ctx.needs_input_grad)]
        return (*grads, None, None, None, None)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
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
    """Causal attention over a paged KV cache.

    q (B, q_len, H, D): the step's new queries (1 row for plain decode, a
    prompt chunk for cache-writing prefill).  k_pages / v_pages
    (P, page, KH, D): one layer's pools, of q's dtype, or int8 with
    ``k_scales`` / ``v_scales`` (P, page, KH) f32.  page_table
    (B, max_pages) int32; lengths (B,) int32 counts each context with the
    new rows, whose K/V are already in the pools.  Returns
    (B, q_len, H, D) in q's dtype.  ``q_chunk`` bounds the rows of one
    kernel q block (default: all of q_len); it changes the blocking, not
    the result.

    ``new_lens`` (B,) int32 selects the verify mode (speculative decode):
    row ``t`` of sequence ``b`` is live iff ``t < new_lens[b]``, at
    position ``lengths[b] - new_lens[b] + t``; dead rows give exact
    zeros.  Its launches count in ``verify_launches``, the plain ones in
    ``launches``.

    A CUDA tensor launches K4 (``csrc/paged_decode.cu``), whose page walk
    is split over CUDA blocks as ``decode.split_plan`` says from the
    shapes; with more than one split, f32 partials go to scratch
    allocated here and a second kernel of the same call combines them.
    ``split_heads`` plans that split for another KV-head count than the
    pools': a rank of a tensor-parallel mesh holding K/m heads passes the
    whole model's K, so its heads split, and combine, as the unsharded
    launch's do, bit for bit.
    """
    b, qs, h, d = q.shape
    p_total, page, kh, dk = k_pages.shape
    if dk != d or h % kh:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit pools {tuple(k_pages.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_decode_attention: need both scale pools "
                         "or neither")
    dev = q.device
    if dev.type == "cpu":
        return _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, lengths, scale=scale,
            window=window, softcap=softcap, k_scales=k_scales,
            v_scales=v_scales, new_lens=new_lens)
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    no_backward("paged_decode_attention (K4)", q, k_pages, v_pages,
                *(x for x in (k_scales, v_scales) if x is not None))
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_decode_attention kernel takes f32 or bf16 "
                        f"q, got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    quant = k_scales is not None
    pool_dtype = torch.int8 if quant else q.dtype
    _check(q, q.dtype, (b, qs, h, d), dev, "q")
    _check(k_pages, pool_dtype, (p_total, page, kh, d), dev, "k_pages")
    _check(v_pages, pool_dtype, (p_total, page, kh, d), dev, "v_pages")
    _check(page_table, torch.int32, (b, page_table.shape[1]), dev,
           "page_table")
    _check(lengths, torch.int32, (b,), dev, "lengths")
    verify = new_lens is not None
    if verify:
        _check(new_lens, torch.int32, (b,), dev, "new_lens")
    if quant:
        _check(k_scales, torch.float32, (p_total, page, kh), dev, "k_scales")
        _check(v_scales, torch.float32, (p_total, page, kh), dev, "v_scales")
    if qs < 1 or page_table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention kernel needs q rows and "
                         f"table pages, got q_len {qs}, max_pages "
                         f"{page_table.shape[1]}")
    scale = scale if scale is not None else d ** -0.5
    sched = _decode.flash_decode_schedule(page_table.shape[1], page,
                                          q_len=qs, window=window,
                                          q_chunk=q_chunk)
    plan = _decode.split_plan(b, split_heads or kh, h // kh, sched)
    partial = (torch.empty(b * qs * h * plan.n_splits * (d + 2),
                           dtype=torch.float32, device=dev)
               if plan.n_splits > 1 else None)
    out = torch.empty((b, qs, h, d), dtype=q.dtype, device=dev)
    fn = _build.library("paged_decode").launch_paged_decode
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scales.data_ptr() if quant else None,
                    v_scales.data_ptr() if quant else None,
                    page_table.data_ptr(), lengths.data_ptr(),
                    new_lens.data_ptr() if verify else None,
                    out.data_ptr(),
                    partial.data_ptr() if partial is not None else None,
                    b, qs, h, kh, d, page, page_table.shape[1],
                    sched.q_chunk, window if window is not None else 0,
                    plan.pages_per_split, plan.n_splits, scale,
                    softcap if softcap is not None else 0.0,
                    int(q.dtype == torch.bfloat16), int(quant),
                    dev.index, torch.cuda.current_stream(dev).cuda_stream),
                 "paged_decode_attention")
    if verify:
        paged_decode_attention.verify_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.verify_launches = 0
