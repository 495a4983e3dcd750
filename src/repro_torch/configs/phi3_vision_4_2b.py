"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (STUB).

32L d_model=3072 32H (MHA kv=32) head_dim=96 d_ff=8192 (SwiGLU)
vocab=32064.  [hf:microsoft/Phi-3-vision-128k-instruct; hf]
The CLIP vision tower is a stub per the brief: ``input_specs`` provides
precomputed patch embeddings (B, 576, d_model) prepended to the text
sequence; the assigned seq_len counts patches + text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    vocab_size=32_064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    ffn_type="swiglu",
    frontend="vision",
    frontend_len=576,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, frontend_len=16,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
