"""Plain PyTorch oracle for the flash-attention kernels (the reference's
``kernels/ref.py`` contract): the simplest possible formulation — no
tiling, no online softmax.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_mask(Sq: int, Sk: int, kv_len: Optional[torch.Tensor], *,
                   causal: bool, window: int, device) -> torch.Tensor:
    """(B or 1, Sq, Sk) boolean visibility mask of the reference.

    Query positions are aligned to the end of the keys (decode style);
    ``causal`` masks the future, ``window > 0`` limits a query to the
    last ``window`` keys, and ``kv_len`` (B,) masks keys at or past each
    sequence's true length.
    """
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    mask = mask[None]
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len.to(device)[:, None, None])
    return mask


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0, kv_len=None):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Sk, hd).  GQA via head grouping.

    Returns (B, H, Sq, hd) in q's dtype, computed in fp32.  Rows with no
    visible key (padded queries under ``kv_len``) come out as exact zeros.
    """
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    group = H // k.shape[1]
    kq = k.float().repeat_interleave(group, dim=1)
    vq = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) / math.sqrt(hd)
    mask = attention_mask(Sq, Sk, kv_len, causal=causal, window=window,
                          device=q.device)[:, None]
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vq)
    out = torch.where(mask.any(-1, keepdim=True), out, torch.zeros_like(out))
    return out.to(q.dtype)
