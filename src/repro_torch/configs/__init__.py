"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the full assigned configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
Every config of the JAX package is here, field for field: the dense,
MoE, SSM, hybrid, vision (``phi3_vision_4_2b``) and encoder-decoder
(``seamless_m4t_medium``) families.
"""
from __future__ import annotations

import importlib

ARCHITECTURES = [
    "gemma2_27b",
    "mistral_large_123b",
    "qwen2_5_3b",
    "chatglm3_6b",
    "distilbert_paper",          # the paper's own integration target
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "mamba2_370m",
    "zamba2_7b",
    "phi3_vision_4_2b",
    "seamless_m4t_medium",
]

_ALIASES = {name.replace("_", "-"): name for name in ARCHITECTURES}


def get_config(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHITECTURES}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHITECTURES}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config()
