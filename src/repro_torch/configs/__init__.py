"""Config registry of the port: the architectures whose layers it runs
(``get_config("yi-6b")``), copied from ``repro.configs``."""
from __future__ import annotations

import importlib

from .base import ArchConfig, MoEConfig  # noqa: F401

_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.CONFIG
