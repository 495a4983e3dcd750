"""qwen2.5-3b [dense] — GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) head_dim=128 d_ff=11008 (SwiGLU)
vocab=151936.  [hf:Qwen/Qwen2.5-*; hf]
QKV bias folds into the paper's dequant epilogue (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    vocab_size=151_936,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    ffn_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
