"""Hymba-style hybrid block: parallel attention and SSM heads
[arXiv:2411.13676].

Counterpart of the reference's ``models/hymba.py``: the normalised
input feeds an attention path and a Mamba2/SSD path in parallel, and
their outputs, each times a learned fp32 scale, are averaged before the
residual add.  ``hymba_decode`` is the cached form for serving: the KV
cache, the SSM state and the convolution state go through both halves.
In training both paths take ``impl``, so ``"flash"`` runs the
attention through the flash kernels and the chunk scan through the SSD
kernel (the reference's hymba always runs ``ssd_chunked``; the port's
ssm block already routes its scan to the kernel, and hymba does the
same).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


def hymba_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The two paths' trees and two fp32 0-d scales (fp32 whatever the
    model's dtype, as in the reference)."""
    return {"attn": L.attention_init(gen, cfg, dtype),
            "ssm": M.mamba2_init(gen, cfg, dtype),
            "attn_scale": torch.ones((), dtype=torch.float32),
            "ssm_scale": torch.ones((), dtype=torch.float32)}


def hymba_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, layer_is_global: bool = False,
                impl: str = "xla",
                seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``seq_lens``: optional (B,) true
    lengths of a bucket-padded batch, threaded into both paths (the
    attention's key mask, the SSD state mask)."""
    attn_out = L.attention_apply(params["attn"], cfg, x, positions=positions,
                                 layer_is_global=layer_is_global, impl=impl,
                                 kv_len=seq_lens)
    ssm_out = M.mamba2_apply(params["ssm"], cfg, x, seq_lens=seq_lens,
                             impl=impl)
    return _combine(params, attn_out, ssm_out, x.dtype)


def _combine(params, attn_out, ssm_out, dtype):
    out = (params["attn_scale"] * attn_out.float()
           + params["ssm_scale"] * ssm_out.float()) * 0.5
    return out.to(dtype)


def hymba_decode(params, cfg: ModelConfig, x: torch.Tensor, *,
                 positions: torch.Tensor, cache: dict, cache_index,
                 layer_is_global: bool = False) -> torch.Tensor:
    """x: (B, C, d) new tokens -> (B, C, d), from the layer's cache
    ``{"k", "v", "ssm", "conv"}``: the attention half writes k and v in
    place (``attention_decode``), the SSM half's new states replace
    ``ssm`` and ``conv`` in the dict."""
    attn_out, _ = L.attention_decode(
        params["attn"], cfg, x, positions=positions, kv_cache=cache,
        cache_index=cache_index, layer_is_global=layer_is_global)
    ssm_out, (cache["ssm"], cache["conv"]) = M.mamba2_decode(
        params["ssm"], cfg, x, cache["ssm"], cache["conv"])
    return _combine(params, attn_out, ssm_out, x.dtype)
