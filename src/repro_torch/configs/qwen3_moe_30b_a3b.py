"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, QK-norm.

48L d_model=2048 32H (GQA kv=4) head_dim=128 vocab=151936,
MoE 128e top-8 with d_ff_expert=768.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    vocab_size=151_936,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    ffn_type="swiglu",
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    router_norm_topk=True,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=8, top_k=2, d_ff_expert=32, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
