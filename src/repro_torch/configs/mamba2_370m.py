"""mamba2-370m [ssm] — attention-free SSD (state-space duality).

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128,
d_inner=2048 (expand 2), ssm_head_dim=64 → 32 SSD heads.
[arXiv:2405.21060; unverified]
The paper's technique applies to the in/out projection GEMMs only; the
selective scan is not a GEMM (DESIGN.md §Arch-applicability).
Runs long_500k: decode state is O(1) — no KV cache at all.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab_size=50_280,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16)
