"""seamless-m4t-medium [audio] — encoder-decoder, multimodal (STUB frontend).

12L (encoder) + 12L (decoder), d_model=1024 16H (MHA kv=16) head_dim=64
d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]
The speech frontend is a stub: ``input_specs`` provides precomputed frame
embeddings (B, T, d_model) as encoder input.  Positions are sinusoidal
absolute (classic enc-dec; deviation from m4t's relative bias noted in
DESIGN.md).  Decode shapes: decoder self-attn cache = seq_len, cross-attn
memory fixed at 4096 encoder frames.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    vocab_size=256_206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    ffn_type="gelu_mlp",
    norm_type="layernorm",
    pos_embedding="sinusoidal",
    rope_style="none",
    frontend="audio",
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
