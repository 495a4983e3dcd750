"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the full assigned configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
The dense, MoE, SSM and hybrid configs the port runs are here; the
vision and encoder-decoder configs come with their families (ROADMAP
queue 1, item 12).
"""
from __future__ import annotations

import importlib

ARCHITECTURES = [
    "gemma2_27b",
    "qwen2_5_3b",
    "chatglm3_6b",
    "distilbert_paper",          # the paper's own integration target
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "mamba2_370m",
    "zamba2_7b",
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
