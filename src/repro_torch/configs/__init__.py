"""Assigned-architecture registry: one module per arch, exact public
configs; `get_config(name)` / `smoke_config(name)` for full/reduced."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "mistral-large-123b",
    "smollm-360m",
    "gemma-7b",
    "deepseek-coder-33b",
    "phi-3-vision-4.2b",
    "kimi-k2-1t-a32b",
    "phi3.5-moe-42b-a6.6b",
    "zamba2-7b",
    "musicgen-large",
    "mamba2-2.7b",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)
