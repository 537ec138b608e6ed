"""Architecture configs (``model_config(arch_id, smoke=)``).

Each module defines CONFIG (the published hyperparameters, the same as the
JAX package's) and SMOKE (a reduced same-family config for CPU tests).
The port's first slice runs the dense family; its one config is qwen3-14b.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["qwen3_14b"]


def canonical(arch_id: str) -> str:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return arch_id


def load(arch_id: str):
    """The config module for an arch id (accepts - or _ forms)."""
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def model_config(arch_id: str, smoke: bool = False, **overrides):
    mod = load(arch_id)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
