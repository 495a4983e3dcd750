"""Unified model configuration covering all 10 assigned architectures.

One frozen dataclass; every architecture in ``repro_torch.configs`` is an
instance.  Field for field the same as the JAX package's ``ModelConfig``
(so a config carries across unchanged); only ``activation_dtype``
differs, returning a torch dtype.
The paper's technique enters through ``quant_proj`` (projection quantization
mode) and ``fuse_qkv`` (the update_A persistent-A fusion) — flipping
``quant_proj`` between "none" and "w8a8" is exactly the paper's
baseline-vs-accelerator comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|vlm|audio|hybrid|ssm
    n_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---------------------------------------------------------
    n_heads: int = 0                 # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    rope_style: str = "full"         # full | partial | none
    rope_fraction: float = 1.0       # fraction of head_dim rotated (chatglm ½)
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"      # rope | sinusoidal | none
    sliding_window: Optional[int] = None
    layer_pattern: str = "uniform"   # uniform | local_global (gemma2)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None     # default head_dim**-0.5
    # --- ffn ----------------------------------------------------------------
    d_ff: int = 0
    ffn_type: str = "swiglu"         # swiglu | geglu | gelu_mlp
    post_block_norm: bool = False    # gemma2 sandwich (pre+post norms)
    # --- moe ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True    # renormalise top-k gate weights
    # --- ssm (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): shared attention block every k ssm layers ----------
    shared_attn_every: int = 0
    # --- encoder-decoder ------------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # --- norms / embeddings ---------------------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    rms_unit_offset: bool = False    # gemma-style (1 + w) RMSNorm weight
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: Optional[float] = None      # gemma sqrt(d), granite mult
    residual_multiplier: float = 1.0         # granite
    logits_multiplier: float = 1.0           # granite logits_scaling (divide)
    # --- modality frontend stubs ----------------------------------------------
    frontend: Optional[str] = None   # vision | audio (precomputed embeddings)
    frontend_len: int = 0            # patches/frames prepended (vision only)
    # --- the paper's technique -------------------------------------------------
    quant_proj: str = "none"         # none | w8 | w8a8 (serving default w8a8)
    fuse_qkv: bool = True            # update_A persistent-A fusion
    # --- numerics / execution ---------------------------------------------------
    dtype: str = "bfloat16"
    parallelism: str = "auto"        # auto | tp | dp (launch-time profile)
    attn_chunk_kv: int = 1024        # blockwise-attention KV chunk
    attn_chunk_q: int = 2048         # blockwise-attention Q chunk
    attn_impl: str = "auto"          # auto | jnp | flash — long-seq attention
    #   auto: flash engine when the Pallas kernels are live, else jnp
    #   jnp: force the pure-jnp blockwise path; flash: force the flash
    #   engine (on CPU its ref oracle — routing/parity tests)
    blockwise_attn_threshold: int = 4096   # use blockwise attn for seq >= this
    remat: str = "block"             # none | block  (checkpoint each layer)
    moe_impl: str = "auto"           # auto | local | sharded (shard_map)

    # ---- derived -----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def activation_dtype(self):
        import torch
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.has_attention:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, \
                (self.n_heads, self.n_kv_heads)
            assert self.head_dim > 0
        if self.is_moe:
            assert 0 < self.top_k <= self.n_experts
            assert self.d_ff_expert > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.layer_pattern == "local_global":
            assert self.sliding_window is not None
        if self.is_encoder_decoder:
            assert self.n_encoder_layers > 0
        assert self.quant_proj in ("none", "w8", "w8a8")
        assert self.attn_impl in ("auto", "jnp", "flash"), self.attn_impl
