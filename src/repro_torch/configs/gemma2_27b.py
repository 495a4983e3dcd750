"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) head_dim=128 d_ff=36864 (GeGLU)
vocab=256000.  [arXiv:2408.00118; hf]
Gemma2 specialties: sandwich norms (pre+post), RMSNorm (1+w), embedding
scaled by sqrt(d_model), attn scale (d_model/n_heads)^-1/2 = 144^-1/2,
attn logit softcap 50, final logit softcap 30, sliding window 4096 on
alternating (even) layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    vocab_size=256_000,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    ffn_type="geglu",
    layer_pattern="local_global",
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    post_block_norm=True,
    rms_unit_offset=True,
    embed_scale=4608 ** 0.5,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16,
        attn_scale=(64 / 4) ** -0.5, embed_scale=64 ** 0.5,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
