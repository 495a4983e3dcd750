"""granite-moe-3b-a800m [moe] — 40 experts top-8, granite multipliers.

32L d_model=1536 24H (GQA kv=8) head_dim=64 vocab=49155,
MoE 40e top-8 with d_ff_expert=512.  [hf:ibm-granite/granite-3.0-*; hf]
Granite specialties: embedding/residual/logits multipliers.
Sharding notes (DESIGN.md §3): 24 heads and vocab 49155 do not divide the
16-way model axis → replicated under the shard-if-divisible policy; the
expert dim (40) likewise → experts replicated, expert_mlp (512) sharded.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    vocab_size=49_155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    ffn_type="swiglu",
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    embed_scale=12.0,            # embedding_multiplier
    residual_multiplier=0.22,
    logits_multiplier=6.0,       # logits_scaling (divides)
    attn_scale=0.015625,         # attention_multiplier
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
        n_experts=8, top_k=2, d_ff_expert=32, vocab_size=256,
        blockwise_attn_threshold=64, attn_chunk_kv=32)
