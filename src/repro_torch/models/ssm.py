"""Mamba2 (SSD — state-space duality) block: chunked scan and O(1) decode.

The counterpart of the JAX package's ``models/ssm.py``.  The projections
are split (``in_z`` / ``in_x`` / ``in_B`` / ``in_C`` / ``in_dt``), each a
quantizable ``Linear``: under w8a8 the five share one input, so one K1 of
it serves them all (``apply_linears``: the int8 rows each separate call
would make, so bitwise the reference's five ``apply_linear`` calls),
then five K2 launches; ``out_proj`` runs K1 + K2.  The depthwise causal
conv (k = 4), the chunked SSD scan, the single-token recurrence and the
gated RMSNorm are plain PyTorch, as the reference's are XLA: neither
package has a kernel for them.

The chunked SSD algorithm follows the Mamba2 paper (arXiv:2405.21060 §6):
an intra-chunk quadratic term and an inter-chunk recurrence on the
(H, P, N) state, with ngroups = 1 (B/C shared across heads).  Where the
reference writes 3- and 4-operand einsums (XLA picks the contraction
order), the port writes them as pairwise products in the order that
keeps the intermediates at the size of the (B, nc, H, cs, cs) decay block
(built and scaled in place) or of x, and the inter-chunk ``lax.scan`` as
a loop over chunks.  The recurrent state and the conv tails stay f32
whatever the activation dtype.

Over a mesh (``bridge.shard_model`` sets ``Mamba2.mesh``; the JAX
package's rules, ``launch/sharding.py``) a rank computes its ``H / m``
SSM heads and their ``d_inner / m`` channels, one cut (``rank_heads``:
``ssm_n_heads`` must divide the ``model`` extent, else it raises).
``in_z`` and ``in_x`` are column-parallel (the rank's channels), ``in_B``,
``in_C`` and ``in_dt`` whole (one K1 still serves all five), ``conv_x``
runs on the rank's channels and ``conv_B`` / ``conv_C`` whole; ``A_log``,
``D``, ``dt_bias`` and the gated norm's weight rest whole (replicated, as
the JAX placement has them) and each rank takes its heads' (channels')
slice at run time.  The scan (``ssd_chunked``), the decode step
(``ssm_step``), the conv tails and the pre-norm ``y`` are therefore
bitwise the unsharded block's slice: no stage mixes heads, and none of
the scan's sums depends on how many heads a call holds (``ssd_chunked``'s
``heads``: the decays' cumulative sums run over all heads, the products
keep the heads in their batch; the decode step's output is a product and
a sum).  The gated RMSNorm's mean runs over the whole ``d_inner``:
each rank sums the squares of its channels in f32, the (B, L, 1) sums
are added in rank order (``launch.mesh.all_reduce``: the same bits on
every rank) and divided by ``d_inner``.  That is another summation order
than one mean over the whole row, so the normed activations, and the
layer output after it, are close to the unsharded ones, not bitwise
(``NORM_MESH_REL``: 1e-5 of the output's largest |value| in f32, 2^-6 in
bf16).  ``out_proj`` is row-parallel (its rows, through
``core.quantized_linear._apply_row_parallel``: under w8a8 the row absmax
by ``pmax`` and the int32 partials summed exactly).

The collectives of one Mamba2 layer, each rank's share of them, at
zamba2-7b's widths (d_model 3584, d_inner 7168, 112 heads; on 4 ranks 28
heads and 1792 channels a rank) and its serve's shapes, a decode step of
4 rows (B·L = 4) and the prefill of 4 prompts padded to 256 tokens
(B·L = 1024):

  * the norm's sums, (B, L, 1) f32: 16 B at decode, 4 KiB at prefill;
  * under w8a8, out_proj's row absmax (``pmax``), (B·L,) f32: 16 B and
    4 KiB;
  * out_proj's int32 partial sums, (B·L, 3584): 56 KiB and 14 MiB (under
    ``none`` / ``w8`` the f32 partials instead, the same bytes).

``Mesh.psum`` gathers every rank's part and adds them in rank order, so
each rank receives the other ranks' parts: three times these bytes on 4
ranks.

A hybrid layer's shared block adds a dense decoder block's collectives
(``models/attention.py``, ``models/ffn.py``).  In training the block's
input enters through ``copy_to`` (its gradient summed over ``model``), the
norm's sum has a sum over ``model`` as its backward too (its result feeds
every rank's channels), and the replicated tensors whose output feeds only
the rank's heads or channels (``in_B``, ``in_C``, ``in_dt``, ``conv_B``,
``conv_C``, ``A_log``, ``D``, ``dt_bias``, the norm's weight) get a share
of their gradient on each rank, which the train step sums
(``launch.sharding.TrainPlacement.partial``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quantized_linear import (Linear, apply_linear,
                                               apply_linears, init_linear)
from repro_torch.launch.mesh import all_reduce, copy_to
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm

IN_PROJ = ("in_z", "in_x", "in_B", "in_C", "in_dt")
# the block's output on a mesh against the unsharded block's, over its
# largest |value| (module docstring), by activation dtype.  The norm's sum
# of squares is added in another order, which moves the f32 mean by a few
# ulps (1.8e-7 of it at the smoke shapes), and a row-parallel out_proj
# under none / w8 sums f32 partials: in f32 the output moves by well under
# 1e-5.  In bf16 the norm's cast may round an element of a row to its
# neighbour (2^-8 of it), all of a row's elements the same way where the
# row's scale crossed, and the unsharded bf16 product rounds where the
# ranks' f32 sum rounds once: within 2^-6
NORM_MESH_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


class ConvWeight(nn.Module):
    """A depthwise conv's taps ``w`` (k, C), f32."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)


class SSMParams(nn.Module):
    """``A_log``, ``D`` and ``dt_bias``, each (H,) f32."""

    def __init__(self, A_log: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor):
        super().__init__()
        self.register_buffer("A_log", A_log)
        self.register_buffer("D", D)
        self.register_buffer("dt_bias", dt_bias)


class Mamba2(nn.Module):
    """The five in-projections, the three convs, the SSM parameters, the
    gated norm's weight ``norm`` and ``out_proj``; ``mesh``, the mesh of a
    rank's shard (``bridge.shard_model``), else None."""

    def __init__(self, in_z: Linear, in_x: Linear, in_B: Linear,
                 in_C: Linear, in_dt: Linear, conv_x: ConvWeight,
                 conv_B: ConvWeight, conv_C: ConvWeight, ssm: SSMParams,
                 norm: Norm, out_proj: Linear):
        super().__init__()
        self.in_z, self.in_x, self.in_B = in_z, in_x, in_B
        self.in_C, self.in_dt = in_C, in_dt
        self.conv_x, self.conv_B, self.conv_C = conv_x, conv_B, conv_C
        self.ssm = ssm
        self.norm = norm
        self.out_proj = out_proj
        self.mesh = None


def _identity_conv(k: int, c: int, device) -> ConvWeight:
    w = torch.zeros((k, c), device=device)
    w[-1] = 1.0
    return ConvWeight(w)


def init_mamba2(generator: torch.Generator, cfg: ModelConfig) -> Mamba2:
    """Random block from ``generator`` on its device, as the reference's
    init: fan-in projections, identity-ish convs, A_log over linspace(1,
    16), D = 1, dt_bias the softplus inverse of dt log-uniform in [1e-3,
    1e-1]."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    dev = generator.device
    k = cfg.ssm_conv
    proj = [init_linear(generator, d, out) for out in (di, di, n, n, h)]
    u = torch.rand((h,), generator=generator, device=dev)
    lo, hi = math.log(0.001), math.log(0.1)
    dt_bias = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
    ssm = SSMParams(torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
                    torch.ones((h,), device=dev), dt_bias)
    out_proj = init_linear(generator, di, d,
                           scale=(di ** -0.5) / max(cfg.n_layers, 1) ** 0.5)
    return Mamba2(*proj, _identity_conv(k, di, dev), _identity_conv(k, n, dev),
                  _identity_conv(k, n, dev), ssm,
                  Norm(torch.ones((di,), device=dev)), out_proj)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv as k shifted adds.  x (B, L, C); w (k, C).

    With ``state`` (B, k-1, C) f32 — decode mode: x is (B, 1, C), returns
    (y (B, 1, C) in x's dtype, the new f32 window tail (B, k-1, C)).
    """
    k = w.shape[0]
    if state is not None:
        window = torch.cat([state.float(), x.float()], dim=1)   # (B, k, C)
        y = (window * w).sum(dim=1, keepdim=True)
        return y.to(x.dtype), window[:, 1:]
    l_len = x.shape[1]
    xf = F.pad(x.float(), (0, 0, k - 1, 0))                     # (B, L+k-1, C)
    y = sum(xf[:, i:i + l_len] * w[i] for i in range(k))
    return y.to(x.dtype), None


def _conv_prefill(x: torch.Tensor, w: torch.Tensor, prev: torch.Tensor,
                  n_valid: torch.Tensor):
    """Depthwise causal conv over a prefill chunk with carried tail state.

    x (B, L, C); w (k, C); prev (B, k-1, C) — the window tail just before
    this chunk.  Returns (y (B, L, C) in x's dtype, new_tail (B, k-1, C)
    f32), the tail being the window that ends at each row's ``n_valid``
    (B,) committed tokens: padded index ``t + (k-1)`` holds position t,
    so the tail reads ``[n_valid, n_valid + k-1)`` — valid tokens or the
    carried tail, never right-padding (``n_valid == 0`` keeps the tail).
    """
    k = w.shape[0]
    l_len = x.shape[1]
    xp = torch.cat([prev.float(), x.float()], dim=1)            # (B, L+k-1, C)
    y = sum(xp[:, i:i + l_len] * w[i] for i in range(k))
    idx = (n_valid.long()[:, None]
           + torch.arange(k - 1, device=x.device)[None, :])     # (B, k-1)
    new_tail = torch.gather(
        xp, 1, idx[..., None].expand(-1, -1, xp.shape[-1]))
    return y.to(x.dtype), new_tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., cs) → (..., cs, cs): the sum over (j, i], -inf above the
    diagonal."""
    return _segsum_of(torch.cumsum(a, dim=-1))


def _segsum_of(cum: torch.Tensor) -> torch.Tensor:
    """``_segsum`` from the cumulative sums ``cum`` (..., cs) of a."""
    cs = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    ii = torch.arange(cs, device=cum.device)
    return diff.masked_fill_(ii[:, None] < ii[None, :], -math.inf)


def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None,
                heads: slice | None = None):
    """Chunked SSD scan.

    x     (B, L, H, P)   — dt-premultiplied inputs
    a_dt  (B, L, H)      — A·dt (negative), f32
    b_mat (B, L, N), c_mat (B, L, N) — shared across heads (ngroups=1)
    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).

    With ``heads``, a_dt holds every head of the model and x,
    ``init_state`` and the outputs only ``heads`` of them (a mesh rank's):
    the decays' cumulative sums run over every head and are then sliced,
    since the card's cumulative sum orders its additions by the tensor's
    shape.  For the same reason the chunk states' product keeps the heads
    in its batch: each head's sums then do not depend on how many heads
    the call holds.
    """
    bsz, l_len, h, p = x.shape
    n = b_mat.shape[-1]
    if l_len % chunk:
        raise ValueError(f"sequence length {l_len} is not a multiple of "
                         f"the SSD chunk {chunk}")
    nc, cs = l_len // chunk, chunk

    # the per-head decays laid out (B, nc, H, cs), chunk before head, so the
    # (B, nc, H, cs, cs) decay block below batches the product over x
    # without a copy
    xc = x.reshape(bsz, nc, cs, h, p).float()
    a_cum = torch.cumsum(a_dt.reshape(bsz, nc, cs, -1).transpose(2, 3),
                         dim=-1)                               # (B,nc,H,cs)
    if heads is not None:
        a_cum = a_cum[:, :, heads]
    bc = b_mat.reshape(bsz, nc, cs, n).float()
    cc = c_mat.reshape(bsz, nc, cs, n).float()

    # intra-chunk ("diagonal block") term: the reference's
    # einsum("bcln,bcsn,bhcls,bcshp->bclhp") as (C B^T) ∘ L, then times x
    # in place where no gradient is taken (the block is the scan's largest)
    inplace = not torch.is_grad_enabled()
    ldec = _segsum_of(a_cum)
    ldec = ldec.exp_() if inplace else ldec.exp()              # (B,nc,H,l,s)
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)[:, :, None]
    ldec = ldec.mul_(cb) if inplace else ldec * cb
    y = torch.einsum("bchls,bcshp->bclhp", ldec, xc)
    del ldec

    # per-chunk states and the inter-chunk recurrence
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,nc,H,cs)
    xd = xc.transpose(2, 3).contiguous() * decay_states[..., None]
    states = torch.matmul(xd.transpose(-1, -2),
                          bc[:, :, None])                      # (B,nc,H,P,N)
    del xd
    chunk_decay = torch.exp(a_cum[..., -1])                    # (B,nc,H)

    h_prev = (init_state.float() if init_state is not None
              else x.new_zeros((bsz, h, p, n), dtype=torch.float32))
    prev_states = []
    for c in range(nc):
        prev_states.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev_states, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk ("off-diagonal") term: the reference's
    # einsum("bcln,bhcpn,bhcl->bclhp") as (C h_prev) times the decay
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev)
    decay = torch.exp(a_cum).transpose(2, 3)[..., None]
    y = y.add_(y_off.mul_(decay)) if inplace else y + y_off * decay
    return y.reshape(bsz, l_len, h, p).to(x.dtype), h_prev


def ssm_step(h_prev: torch.Tensor, x_dt: torch.Tensor, da: torch.Tensor,
             b_row: torch.Tensor, c_row: torch.Tensor):
    """One token of the SSD recurrence: ``h, y = ssm_step(h, x)``.

    h_prev (B, H, P, N) f32; x_dt (B, H, P) dt-premultiplied input; da
    (B, H) per-head decay ``exp(dt·A)``; b_row / c_row (B, N) the token's
    conv'd B/C projections.  Returns (h_new (B, H, P, N) f32, y (B, H, P)
    f32): the state update of ``ssd_chunked``, one token at a time.
    """
    xb = x_dt.float()[..., None] * b_row.float()[:, None, None, :]
    h_new = h_prev * da[..., None, None] + xb
    # a product and a sum over N, not a GEMV over (H·P, N): the sum's order
    # then does not depend on how many heads the call holds (a mesh rank's)
    y = (h_new * c_row.float()[:, None, None, :]).sum(dim=-1)
    return h_new, y


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float, dtype, mesh=None, width: int | None = None
                ) -> torch.Tensor:
    """Mamba2's gated RMSNorm ``norm(y * silu(z))``, f32 inside.  On a
    ``mesh`` of more than one rank, y and z hold the rank's channels and
    ``w`` its slice of the weight: the sums of squares are added over the
    mesh and divided by the whole row's ``width`` (module docstring)."""
    gf = (y * F.silu(z)).float()
    if mesh is None or mesh.size == 1:
        ms = (gf * gf).mean(dim=-1, keepdim=True)
    else:
        ms = all_reduce(mesh, (gf * gf).sum(dim=-1, keepdim=True)) / width
    rms = torch.rsqrt(ms + eps)
    return (gf * rms * w).to(dtype)


def check_head_split(heads: int, m: int) -> None:
    """Raise unless ``heads`` SSM heads split evenly over a ``model`` axis
    of ``m`` ranks: a rank's ``ssm_inner`` channels (its columns of
    ``in_z`` / ``in_x``, rows of ``out_proj``, channels of ``conv_x`` and
    of its state) must be whole heads, which the channels' own
    divisibility does not ensure."""
    if heads % m:
        raise ValueError(f"{heads} SSM heads do not split over a model "
                         f"axis of {m} ranks: a rank's ssm_inner channels "
                         "must be whole heads")


def rank_heads(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """[lo, hi) of the SSM heads this rank of ``mesh`` computes: its equal
    share, whose ``P``-wide channels are its ``d_inner / m`` columns of
    ``in_z`` / ``in_x`` (``check_head_split``)."""
    check_head_split(cfg.ssm_n_heads, mesh.size)
    return mesh.shard_bounds(cfg.ssm_n_heads)


def apply_mamba2(params: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                 state: dict | None = None,
                 n_valid: torch.Tensor | None = None):
    """Mamba2 block over x (B, L, D).  Three modes:

    * **cache-less** — ``state=None``: the chunked SSD scan with chunk
      ``min(cfg.ssm_chunk, L)`` (L must be a multiple of it), no state
      carried in or out.
    * **decode** — ``state`` given, L = 1, no ``n_valid``: one step of
      the recurrence (``ssm_step``) and of the conv windows.  ``state``
      is {"h": (B, H, P, N) f32, "conv_x": (B, k-1, d_inner) f32,
      "conv_B" / "conv_C": (B, k-1, N) f32}.
    * **prefill-commit** — ``state`` given and L > 1 (or ``n_valid``
      passed): the chunk runs through ``ssd_chunked`` from ``state["h"]``
      and the state advances by each row's ``n_valid`` (B,) committed
      tokens: ``dt`` is zeroed past it after the softplus (decay 1,
      contribution 0, so right-padding is invisible) and the conv tails
      end at each row's last valid token.  L is padded to a multiple of
      the fixed ``cfg.ssm_chunk``, never ``min(chunk, L)``: a
      width-dependent chunk would regroup the inter-chunk sum and break
      parity across padded prompt widths.

    On a mesh (``params.mesh`` of more than one rank) x is the whole
    (B, L, D) input and ``state`` holds this rank's slices (``h`` of its
    heads, ``conv_x`` of its channels); the output is the whole block's,
    the same bits on every rank (module docstring).

    Returns (y (B, L, D), the new state dict or None).  The state tensors
    are new: the caller writes them into its cache.
    """
    bsz, l_len, _ = x.shape
    p = cfg.ssm_head_dim
    mode = cfg.quant_proj
    mesh = params.mesh
    split = mesh is not None and mesh.size > 1
    lo, hi = rank_heads(cfg, mesh) if split else (0, cfg.ssm_n_heads)
    h = hi - lo                                                # this rank's
    if split:
        x = copy_to(mesh, x)

    z, xs, bm, cm, dt = apply_linears(
        [getattr(params, name) for name in IN_PROJ], x, mode=mode)

    decode = state is not None and l_len == 1 and n_valid is None
    commit = state is not None and not decode
    if commit:
        nv = (torch.full((bsz,), l_len, dtype=torch.long, device=x.device)
              if n_valid is None else torch.as_tensor(
                  n_valid, device=x.device).long())
    tails, outs = {}, []
    for v, key in zip((xs, bm, cm), ("conv_x", "conv_B", "conv_C")):
        w = getattr(params, key).w
        if commit:
            y_c, tails[key] = _conv_prefill(v, w, state[key], nv)
        else:
            y_c, tails[key] = _causal_conv(v, w,
                                           state[key] if decode else None)
        outs.append(F.silu(y_c))
    xs, bm, cm = outs

    # the decays over all H heads (a few numbers a token), sliced where
    # used: on the CPU a loop's short tail runs the scalar exp and the rest
    # the vector one, so the rank's exp of its slice could differ in a bit
    a = -torch.exp(params.ssm.A_log)                           # (H,)
    dt = torch.logaddexp(dt.float() + params.ssm.dt_bias,
                         dt.new_zeros((), dtype=torch.float32))  # softplus
    if commit:
        # padded steps: decay exp(dt·A) = 1, contribution x·dt = 0
        live = torch.arange(l_len, device=x.device)[None, :] < nv[:, None]
        dt = torch.where(live[..., None], dt, 0.0)
    a_dt = dt * a                                              # (B, L, H)
    heads = slice(lo, hi)
    x_hd = xs.reshape(bsz, l_len, h, p)
    x_dt = x_hd * dt[..., heads, None].to(x_hd.dtype)

    if state is None:
        y, final = ssd_chunked(x_dt, a_dt, bm, cm,
                               min(cfg.ssm_chunk, l_len), heads=heads)
        new_state = None
    elif commit:
        pad = -l_len % cfg.ssm_chunk
        y, final = ssd_chunked(
            F.pad(x_dt, (0, 0, 0, 0, 0, pad)), F.pad(a_dt, (0, 0, 0, pad)),
            F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad)),
            cfg.ssm_chunk, init_state=state["h"], heads=heads)
        y = y[:, :l_len]
        new_state = {"h": final, **tails}
    else:
        da = torch.exp(a_dt[:, 0])[:, heads]                   # (B, h)
        h_new, y = ssm_step(state["h"], x_dt[:, 0], da, bm[:, 0], cm[:, 0])
        y = y[:, None].to(x_hd.dtype)
        new_state = {"h": h_new, **tails}

    y = y + x_hd * params.ssm.D[lo:hi][None, None, :, None].to(x_hd.dtype)
    g = _gated_norm(y.reshape(bsz, l_len, h * p), z,
                    params.norm.w[lo * p:hi * p], cfg.norm_eps, x.dtype,
                    mesh if split else None, cfg.d_inner)
    return apply_linear(params.out_proj, g, mode=mode), new_state
