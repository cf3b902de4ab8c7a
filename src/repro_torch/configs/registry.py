"""Architecture registry for the archs the port serves: --arch <id> ->
(full config, reduced config).  Other archs of ``repro.configs.registry``
join as their families are ported (ROADMAP.md, queue 1, item 11)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_ARCH_MODULES)} (other archs: ROADMAP.md "
                       f"queue 1, item 11)")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
