"""Architecture registry for the archs the port runs: --arch <id> ->
(full config, reduced config), under the names of
``repro.configs.registry``.  Other archs join as their families are
ported (ROADMAP.md, queue 1, item 11)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "dlrm0": "repro_torch.configs.dlrm0",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{sorted(_ARCH_MODULES)} (other archs: ROADMAP.md "
                       f"queue 1, item 11)")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
