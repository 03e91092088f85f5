"""--arch <id> registry: every architecture of the JAX package."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "granite-8b": "repro_torch.configs.granite_8b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-base": "repro_torch.configs.whisper_base",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
