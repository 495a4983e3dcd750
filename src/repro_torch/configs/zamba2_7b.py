"""zamba2-7b [hybrid] — Mamba2 backbone + parameter-shared attention block.

81L d_model=3584 32H (MHA kv=32) head_dim=112 d_ff=14336 vocab=32000,
ssm_state=64.  [arXiv:2411.15242; unverified]
The shared transformer block (attn + SwiGLU FFN, one set of parameters) is
applied every 6 Mamba2 layers — 13 application sites, each with its own KV
cache (real zamba2 adds per-site LoRA deltas; omitted, noted in DESIGN.md).
Runs long_500k: decode state is O(1) per Mamba layer; only the 13 shared
attention sites carry 500k KV.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    ffn_type="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
        shared_attn_every=3, ssm_chunk=16,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
