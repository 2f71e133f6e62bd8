"""Architecture registry: ``--arch <id>`` -> (``ModelConfig``, ``LM``).

Holds the configurations the port runs -- every one of the
reference's -- under the reference's ids, in its order, and its dashed
public names.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig
from repro_torch.models.lm import LM, build_model

ARCH_IDS = [
    "mamba2_1p3b",
    "seamless_m4t_large_v2",
    "granite_moe_1b_a400m",
    "gemma3_12b",
    "yi_9b",
    "stablelm_3b",
    "qwen2_vl_7b",
    "qwen3_1p7b",
    "hymba_1p5b",
    "kimi_k2_1t_a32b",
    # the paper's own evaluation model (Bert-base scale)
    "bert_base_paper",
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


def get_model(arch: str, attn_impl: str = "xla", *, device="cuda") -> LM:
    """The full-size model of ``arch``, its parameters drawn (seed 0) on
    ``device``.  Refuses a configuration in ``REDUCED_ONLY``: build its
    ``get_config(arch).reduced(...)`` with ``build_model`` instead."""
    if canonical(arch) in REDUCED_ONLY:
        raise ValueError(f"{arch} trains only reduced "
                         f"({REDUCED_ONLY[canonical(arch)]})")
    return build_model(get_config(arch), attn_impl=attn_impl, device=device)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
