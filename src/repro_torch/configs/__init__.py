"""Assigned architecture configs (one module per arch) + registry, copied
from ``repro.configs`` (they are data).

Every config cites its source in the module docstring. ``get_config(arch_id)``
returns the full ``ModelConfig``; ``get_config(arch_id, reduced=True)`` the
smoke-test variant (2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "deepseek_7b",
    "hymba_1_5b",
    "glm4_9b",
    "qwen3_moe_235b_a22b",
    "seamless_m4t_medium",
    "xlstm_1_3b",
    "gemma_7b",
    "llama4_maverick_400b_a17b",
    "qwen2_vl_2b",
    "qwen2_5_3b",
]

# CLI-facing ids use dashes/dots
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update(
    {
        "deepseek-7b": "deepseek_7b",
        "hymba-1.5b": "hymba_1_5b",
        "glm4-9b": "glm4_9b",
        "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
        "seamless-m4t-medium": "seamless_m4t_medium",
        "xlstm-1.3b": "xlstm_1_3b",
        "gemma-7b": "gemma_7b",
        "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
        "qwen2-vl-2b": "qwen2_vl_2b",
        "qwen2.5-3b": "qwen2_5_3b",
    }
)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    key = ALIASES.get(arch_id, arch_id)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


LONG_WINDOW = 8192


def long_decode_variant(cfg: ModelConfig) -> ModelConfig:
    """The sub-quadratic variant used for the ``long_500k`` shape.

    SSM/hybrid archs run natively (O(1)/O(window) state). Dense/MoE/VLM archs
    switch to sliding-window attention (window 8192, ring-buffer KV cache).
    Encoder-decoder archs have no sub-quadratic family variant — callers must
    skip them (``supports_long_context`` is False).
    """
    import dataclasses

    if cfg.family in ("ssm", "hybrid"):
        return cfg
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.arch_id}: no sub-quadratic variant (enc-dec)")
    return dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
