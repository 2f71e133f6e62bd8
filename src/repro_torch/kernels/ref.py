"""Plain PyTorch oracles for the kernels (the reference's ``kernels/ref.py``
contract): the simplest possible formulations — no tiling, no online
softmax, no chunking.
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


def ssd_reference(x, dt, A, B, C, initial_state=None, kv_len=None):
    """Naive O(S) sequential SSD recurrence (the definition).

    x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,); B, C: (Bt, S, N).
    Returns (y (Bt, S, H, P) in x's dtype, final_state (Bt, H, P, N) fp32).

      state_t = exp(dt_t * A) * state_{t-1} + dt_t * B_t x_t
      y_t     = C_t . state_t

    ``kv_len``: optional (Bt,) true lengths — dt is zeroed past a
    sequence's length, so padding never enters the state.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if kv_len is not None:
        valid = (torch.arange(S, device=x.device)[None, :, None]
                 < kv_len.to(x.device)[:, None, None])
        dt = torch.where(valid, dt, torch.zeros((), dtype=dt.dtype,
                                                device=dt.device))
    state = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    dtf, xf, Bf, Cf = dt.float(), x.float(), B.float(), C.float()
    Af = A.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)                         # (Bt, H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), state
