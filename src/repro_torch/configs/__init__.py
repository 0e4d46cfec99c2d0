"""Assigned-architecture registry: ``get(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the exact assigned configuration) and
``SMOKE`` (a reduced same-family configuration for CPU tests).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = [
    "command_r_plus_104b",
    "granite_3_2b",
    "minicpm_2b",
    "gemma_2b",
    "whisper_base",
    "granite_moe_1b_a400m",
    "mixtral_8x22b",
    "llama_3_2_vision_11b",
    "mamba2_130m",
    "zamba2_2_7b",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {i: get(i) for i in ARCH_IDS}
