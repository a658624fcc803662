"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
smoke tests. ``SHAPES`` defines the assigned input-shape set.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_30b_a3b",
    "mixtral_8x7b",
    "jamba_1_5_large_398b",
    "phi3_medium_14b",
    "starcoder2_15b",
    "gemma3_12b",
    "gemma_2b",
    "musicgen_large",
    "xlstm_350m",
    "paligemma_3b",
    "swin_moe_small",
    "swin_moe_base",
]

ALIASES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi3-medium-14b": "phi3_medium_14b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma3-12b": "gemma3_12b",
    "gemma-2b": "gemma_2b",
    "musicgen-large": "musicgen_large",
    "xlstm-350m": "xlstm_350m",
    "paligemma-3b": "paligemma_3b",
    "swin-moe-small": "swin_moe_small",
    "swin-moe-base": "swin_moe_base",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE_CONFIG
