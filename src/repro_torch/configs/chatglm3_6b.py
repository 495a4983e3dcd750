"""chatglm3-6b [dense] — 2d (partial) RoPE, GQA kv=2, QKV bias.

28L d_model=4096 32H (GQA kv=2) head_dim=128 d_ff=13696 (SwiGLU)
vocab=65024.  [arXiv:2406.12793; hf]
"RoPE 2d": rotary applied to half of head_dim (rope_fraction=0.5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    vocab_size=65_024,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    ffn_type="swiglu",
    qkv_bias=True,
    rope_style="partial",
    rope_fraction=0.5,
    norm_type="rmsnorm",
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
