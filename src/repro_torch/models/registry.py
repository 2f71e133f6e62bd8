"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Holds only the configurations the port runs.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = ["bert_base_paper", "mamba2_1p3b"]


def canonical(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "p")


def get_config(arch: str) -> ModelConfig:
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
