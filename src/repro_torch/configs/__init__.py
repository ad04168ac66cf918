"""Configurations of the port: the paper's own system (``paper.py``, the
stemmer pipeline) and the LM architecture registry,
``get_config("<arch-id>")``, copied from the reference's."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    shapes_for,
    smoke_config,
)

ARCHS = {
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma-2b": "gemma_2b",
    "llama3-8b": "llama3_8b",
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.config()


def all_configs() -> dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCHS}
