"""mistral-large-123b [dense] — llama-style dense transformer.

88L d_model=12288 96H (GQA kv=8) head_dim=128 d_ff=28672 (SwiGLU)
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
Largest assigned model — the most representative target for the paper's
tiled-GEMM technique at scale (projection GEMMs of 12288×12288).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    vocab_size=32_768,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    ffn_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
