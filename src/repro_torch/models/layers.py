"""Shared building blocks: norms, embeddings, positions, softcap."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
class Norm(nn.Module):
    """LayerNorm (``w``, ``b``) or RMSNorm (``w``) parameters, f32."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)


def init_norm(cfg: ModelConfig, dim: int | None = None, *,
              device="cpu") -> Norm:
    dim = dim or cfg.d_model
    if cfg.norm_type == "layernorm":
        return Norm(torch.ones((dim,), device=device),
                    torch.zeros((dim,), device=device))
    w0 = 0.0 if cfg.rms_unit_offset else 1.0
    return Norm(torch.full((dim,), w0, device=device))


def apply_norm(params: Norm, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """f32 inside, cast back to x's dtype.  LayerNorm uses the population
    variance, as ``jnp.var``."""
    dtype = x.dtype
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        return (y * params.w + params.b).to(dtype)
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    w = params.w + 1.0 if cfg.rms_unit_offset else params.w
    return (xf * rms * w).to(dtype)


# --------------------------------------------------------------------------
# Softcap (gemma2): cap * tanh(x / cap)
# --------------------------------------------------------------------------
def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# --------------------------------------------------------------------------
# Token embedding + LM head
# --------------------------------------------------------------------------
class Embedding(nn.Module):
    """Token table (vocab, d_model), f32.  Over a serving mesh
    (``bridge.shard_model``) a rank holds its slice of the vocabulary:
    ``shard == "vocab"``, ``mesh`` its mesh."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.register_buffer("table", table)
        self.shard: str | None = None
        self.mesh = None


class LMHead(nn.Module):
    """Untied output head ``w`` (vocab, d_model), f32; ``shard`` and
    ``mesh`` as ``Embedding``'s."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)
        self.shard: str | None = None
        self.mesh = None


def init_embedding(generator: torch.Generator, cfg: ModelConfig) -> Embedding:
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                        device=generator.device) * (cfg.d_model ** -0.5)
    return Embedding(table)


def embed_tokens(params: Embedding, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The tokens' rows of the table (scaled, in the activation dtype).  A
    vocab-parallel table looks up the tokens it holds, zeros for the
    others, and sums over the mesh: each row comes from one rank, so the
    sum is the unsharded lookup."""
    if params.shard == "vocab":
        mesh = params.mesh
        n = params.table.shape[0]
        local = tokens - mesh.rank * n
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None], params.table[local.clamp(0, n - 1)],
                        0.0)
        x = mesh.psum(x)
    else:
        x = params.table[tokens]
    if cfg.embed_scale is not None:
        x = x * cfg.embed_scale
    return x.to(cfg.activation_dtype)


def unembed(params: Embedding, x: torch.Tensor, cfg: ModelConfig,
            head_params: LMHead | None = None) -> torch.Tensor:
    """Logits in f32; tied (embed table) or separate head; final softcap.
    A vocab-parallel table gives this rank's columns of the logits, which
    are gathered over the mesh in rank order (the whole vocabulary on
    every rank)."""
    head = head_params if head_params is not None else params
    table = head.w if head_params is not None else params.table
    logits = x.float() @ table.float().t()
    if head.shard == "vocab":
        logits = head.mesh.all_gather(logits, dim=-1)
    if cfg.logits_multiplier != 1.0:
        logits = logits / cfg.logits_multiplier
    return softcap(logits, cfg.final_logit_softcap)


# --------------------------------------------------------------------------
# Rotary position embedding: full / partial (chatglm 2d-RoPE = rotate part
# of head_dim, pairwise-interleaved) — applied to (B, S, H, D)
# --------------------------------------------------------------------------
def _rope_angles(positions: torch.Tensor, rot_dim: int, theta: float):
    exponent = (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                             device=positions.device) / rot_dim)
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq          # (..., S, rot/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    if cfg.rope_style == "none" or cfg.pos_embedding != "rope":
        return x
    d = x.shape[-1]
    rot_dim = int(d * cfg.rope_fraction) if cfg.rope_style == "partial" else d
    rot_dim -= rot_dim % 2
    sin, cos = _rope_angles(positions, rot_dim, cfg.rope_theta)
    sin = sin[..., None, :]            # broadcast over heads: (B,S,1,rot/2)
    cos = cos[..., None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    rotated = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot_dim:]], dim=-1)


# --------------------------------------------------------------------------
# Sinusoidal absolute positions (DistilBERT-paper, seamless-m4t)
# --------------------------------------------------------------------------
def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    log_base = torch.log(torch.tensor(10_000.0, dtype=torch.float32))
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32)
                     / half).to(positions.device)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

