"""Architecture registry of the port: --arch <id> -> (full config, reduced
config), under the names and in the order of ``repro.configs.registry``,
whose ``ALL_ARCHS`` equals `ARCHS`."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "whisper-small": "repro_torch.configs.whisper_small",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "dlrm0": "repro_torch.configs.dlrm0",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
