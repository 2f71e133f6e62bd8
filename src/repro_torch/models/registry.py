"""Architecture registry: ``--arch <id>`` -> ``ModelConfig``.

Holds the configurations the port runs -- every one of the
reference's -- under the reference's ids and its dashed public names.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = [
    "bert_base_paper",
    "mamba2_1p3b",
    "granite_moe_1b_a400m",
    "kimi_k2_1t_a32b",
    "hymba_1p5b",
    "qwen3_1p7b",
    "yi_9b",
    "seamless_m4t_large_v2",
    "qwen2_vl_7b",
    "stablelm_3b",
    "gemma3_12b",
]

# configurations that train only reduced: their full-size weights do
# not fit one device (the reference only dry-runs them at full size)
REDUCED_ONLY = {"kimi_k2_1t_a32b": "about 1 T parameters"}

# the reference's dashed public names (src/repro/models/registry.py)
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "gemma3-12b": "gemma3_12b",
    "yi-9b": "yi_9b",
    "stablelm-3b": "stablelm_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen3-1.7b": "qwen3_1p7b",
    "hymba-1.5b": "hymba_1p5b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def get_config(arch: str) -> ModelConfig:
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port runs: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
