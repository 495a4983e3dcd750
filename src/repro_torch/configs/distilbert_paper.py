"""distilbert (paper §6.2) — the paper's own integration target.

DistilBERT [arXiv:1910.01108]: 6L d_model=768 12H d_ff=3072 vocab=30522,
LayerNorm, GELU MLP, learned/sinusoidal positions, bidirectional encoder.
The paper replaces the Q/K/V linears with FPGAQuantizedLinear; here the
same model runs with quant_proj='w8a8' + fuse_qkv — the exact activation
shape (64 tokens × 768) × (768, 768/3072) GEMMs of paper Table 2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="distilbert-paper",
    family="dense",
    n_layers=6,
    d_model=768,
    vocab_size=30_522,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    ffn_type="gelu_mlp",
    norm_type="layernorm",
    pos_embedding="sinusoidal",
    rope_style="none",
    tie_embeddings=True,
    quant_proj="w8a8",           # the paper's configuration
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=128, vocab_size=256)
