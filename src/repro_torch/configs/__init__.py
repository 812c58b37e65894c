"""Assigned-architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "mamba2-130m",
    "internvl2-2b",
    "whisper-tiny",
    "phi4-mini-3.8b",
    "granite-20b",
    "qwen2.5-3b",
    "starcoder2-15b",
    "hymba-1.5b",
    "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, **overrides):
    cfg = _mod(arch).config()
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides):
    cfg = _mod(arch).smoke_config()
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)
