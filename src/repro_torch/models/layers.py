"""Core layers shared by the model families: plain functions on tensors.

Counterpart of the reference's ``models/layers.py``.  Parameters are
dict-like (``nn.ParameterDict`` or plain dicts of tensors) in the
reference's layout: dense weights stored ``(d_in, d_out)`` and applied
as ``x @ w``.  All shapes follow ``(batch, seq, d_model)``.  Attention
takes GQA, RoPE or M-RoPE, causal / sliding-window / per-layer
local-global masks, qk-norm, bidirectional self attention (the encoder)
and cross attention over precomputed keys and values (the decoder of an
encoder-decoder); the plain path of a local layer runs the banded
``sdpa_banded_local`` where the reference does.  ``attention_decode`` is
the cached form serving runs: it writes the new keys and values into a
KV cache and attends over it (``sdpa_reference``, as the reference's
decode).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.sharding.dtensor import (even, hold, local_attention,
                                          split_heads)

NEG_INF = float(torch.finfo(torch.float32).min)


# ---------------------------------------------------------------------------
# initialisation (the reference's distributions, from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    return (torch.randn(d_in, d_out, generator=gen)
            / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return (torch.randn(vocab, d, generator=gen) * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype) -> dict:
    return {"scale": torch.ones(d, dtype=dtype)}


def attention_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    p = {"wq": dense_init(gen, d, cfg.num_heads * hd, dtype),
         "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
         "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
         "wo": dense_init(gen, cfg.num_heads * hd, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype)
        p["k_norm"] = rmsnorm_init(hd, dtype)
    return p


def mlp_init(gen: torch.Generator, d: int, ff: int, act: str,
             dtype) -> dict:
    p = {"wi": dense_init(gen, d, ff, dtype)}
    if act == "swiglu":
        p["wg"] = dense_init(gen, d, ff, dtype)
    p["wo"] = dense_init(gen, ff, d, dtype)
    return p


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl).  x: (B, S, H, hd); positions: (3, B,
    S) integer, the (t, h, w) streams.  The hd/2 frequency slots are cut
    into ``sections`` groups; slot j rotates by stream ``group(j) % 3``.
    The section map is cut to hd/2 slots, as the reference's is."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long)
                     for i, s in enumerate(sections)])[: hd // 2]
    streams = positions.permute(1, 2, 0).float()           # (B, S, 3)
    idx = (sec.to(x.device) % 3).expand(*streams.shape[:2], sec.numel())
    angles = torch.gather(streams, -1, idx) * freqs        # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def build_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               is_global: bool) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask: causal, plus the sliding window on
    local layers (global layers ignore the window)."""
    causal = q_pos[..., :, None] >= k_pos[..., None, :]
    if window <= 0 or is_global:
        return causal
    return causal & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)


def sdpa_banded_local(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window attention with O(S * 2W) score tiles.

    q: (B, S, H, hd); k, v: (B, S, Hkv, hd); S % window == 0 and
    S >= 2 * window.  Each block of W queries attends its own key block
    and the previous one (zeros before block 0) under the causal window
    mask, so the far-past columns are never materialised.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    W = window
    nb = S // W
    qb = q.reshape(B, nb, W, Hkv, group, hd)
    kb = k.reshape(B, nb, W, Hkv, hd)
    vb = v.reshape(B, nb, W, Hkv, hd)
    kprev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :nb]
    vprev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :nb]
    k2 = torch.cat([kprev, kb], dim=2)                 # (B, nb, 2W, Hkv, hd)
    v2 = torch.cat([vprev, vb], dim=2)
    logits = torch.einsum("bnqkgh,bnskh->bnkgqs", qb.float(),
                          k2.float()) / math.sqrt(hd)
    # query a of a block sees key b - W relative to the block's start
    a = torch.arange(W, device=q.device)[:, None]
    b = torch.arange(2 * W, device=q.device)[None, :] - W
    mask = (a >= b) & ((a - b) < W)                    # causal + window
    mask0 = mask & (b >= 0)                            # block 0: no prev
    first = torch.arange(nb, device=q.device)[:, None, None] == 0
    m = torch.where(first, mask0[None], mask[None])    # (nb, W, 2W)
    logits = logits.masked_fill(~m[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", probs.to(v.dtype), v2)
    return out.reshape(B, S, H, hd)


def sdpa_reference(q, k, v, mask) -> torch.Tensor:
    """Plain attention with GQA.  q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd);
    mask broadcastable to (B, Sq, Sk) boolean; masked scores are set to
    ``finfo(float32).min``, as in the reference."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    q_ = q.reshape(B, Sq, Hkv, group, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q_.float(), k.float())
    logits = logits / math.sqrt(hd)
    m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions,
                 mrope_positions, cross_kv):
    """q (B, S, H, hd), k and v (B, S or Sk, Hkv, hd): the projections,
    qk-norm and RoPE (M-RoPE when ``cfg.mrope`` and ``mrope_positions``
    are given) of self attention, or ``cross_kv`` as they are."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = split_heads(x @ params["wq"], cfg.num_heads, hd)
    if cross_kv is None:
        k = split_heads(x @ params["wk"], cfg.num_kv_heads, hd)
        v = split_heads(x @ params["wv"], cfg.num_kv_heads, hd)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if cross_kv is None:
        if cfg.mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections)
            k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, layer_is_global: bool = True,
                    impl: str = "xla",
                    kv_len: Optional[torch.Tensor] = None,
                    mrope_positions: Optional[torch.Tensor] = None,
                    cross_kv: Optional[tuple] = None,
                    causal: bool = True) -> torch.Tensor:
    """Attention without a cache (training / prefill).

    * self attention, causal (``causal=True``) or bidirectional (the
      encoder's, ``causal=False``);
    * cross attention: ``cross_kv = (k, v)``, (B, Sk, Hkv, hd) each,
      projected from the encoder's output by the caller; no RoPE and
      no qk-norm on them, every key visible.
    * ``kv_len``: optional (B,) int32 true lengths of a bucket-padded
      batch — padded keys of self attention are masked out (and
      skipped tile-wise by the flash kernels).
    * ``mrope_positions``: (3, B, S) positions of M-RoPE, used in place
      of ``positions`` when ``cfg.mrope`` is set.

    ``impl="flash"`` runs the hand-written kernels on causal self
    attention, the only kind the reference sends to its kernel; the
    encoder's and the cross attention run ``sdpa_reference`` on either
    impl.  ``"xla"`` (the reference's name) runs ``sdpa_reference``, or
    on a local causal layer with ``S % W == 0`` and ``S >= 2 W`` the
    banded ``sdpa_banded_local`` (with or without ``kv_len``, as the
    reference: the band is causal and padding a suffix, so a valid
    query only sees valid keys).
    """
    if impl not in ("xla", "flash"):
        raise ValueError(f"attn impl must be 'xla' or 'flash', not {impl!r}")
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, mrope_positions,
                           cross_kv)
    # on DTensors: each device's batch rows and heads
    out = local_attention(_attend, q, k, v, positions, kv_len,
                          window=cfg.sliding_window,
                          layer_is_global=layer_is_global, impl=impl,
                          causal_self=cross_kv is None and causal,
                          cross=cross_kv is not None)
    return hold(out.reshape(B, S, cfg.num_heads * hd)) @ params["wo"]


def _attend(q, k, v, positions, kv_len, *, window: int,
            layer_is_global: bool, impl: str, causal_self: bool,
            cross: bool) -> torch.Tensor:
    """The attention of ``attention_apply`` on projected q (B, S, H, hd),
    k, v (B, Sk, Hkv, hd): (B, S, H, hd)."""
    B, S = q.shape[:2]
    W = window
    is_local = not layer_is_global and W > 0
    if impl == "flash" and causal_self:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.flash_attention(q, k, v, kv_len, causal=True,
                                          window=W if is_local else 0)
    if causal_self and is_local and S % W == 0 and S >= 2 * W:
        return sdpa_banded_local(q, k, v, W)
    Sk = k.shape[1]
    if causal_self:
        mask = build_mask(positions, positions, W, layer_is_global)
    else:
        mask = torch.ones((B, S, Sk), dtype=torch.bool, device=q.device)
    if kv_len is not None and not cross:
        # bidirectional: a padded key would reach every valid query
        key_valid = torch.arange(Sk, device=q.device)[None, :] \
            < kv_len[:, None]                                  # (B, Sk)
        mask = mask & key_valid[:, None, :]
    return sdpa_reference(q, k, v, mask)


def cache_write(buf: torch.Tensor, new: torch.Tensor, index) -> None:
    """Write ``new`` (B, C, ...) into ``buf`` (B, Smax, ...) in place at
    sequence position ``index``.

    * An int: the rows ``[s, s + C)`` of every batch row, with the start
      clamped to ``[0, Smax - C]`` as ``jax.lax.dynamic_update_slice``
      clamps it.
    * A (B,) integer tensor: row b at ``[index[b], index[b] + C)``;
      positions outside ``[0, Smax)`` write nothing (the reference's
      scatter ``mode="drop"``), so a row parked at ``index == Smax``
      keeps its cache.  Each such position is sent to its column modulo
      Smax with the value already there, so every write of a row has its
      own column (C <= Smax) and the scatter has no conflicting
      writes."""
    B, C = new.shape[:2]
    Smax = buf.shape[1]
    if C > Smax:
        raise ValueError(f"{C} new positions do not fit a cache of {Smax}")
    new = new.to(buf.dtype)
    if isinstance(index, torch.Tensor) and index.ndim >= 1:
        cols = index.to(device=buf.device, dtype=torch.long)[:, None] \
            + torch.arange(C, device=buf.device)               # (B, C)
        valid = (cols >= 0) & (cols < Smax)
        cols = torch.remainder(cols, Smax)
        rows = torch.arange(B, device=buf.device)[:, None].expand(B, C)
        keep = valid.reshape(B, C, *([1] * (new.ndim - 2)))
        buf[rows, cols] = torch.where(keep, new, buf[rows, cols])
    else:
        s = min(max(int(index), 0), Smax - C)
        buf[:, s:s + C] = new


def attention_decode(params, cfg: ModelConfig, x: torch.Tensor, *,
                     positions: torch.Tensor, kv_cache: dict, cache_index,
                     layer_is_global: bool = True,
                     mrope_positions: Optional[torch.Tensor] = None):
    """Self attention over a KV cache (decode and chunked prefill): the
    reference's ``attention_apply`` with ``kv_cache``.  Returns ``(out,
    kv_cache)``.

    x: (B, C, d), the C new tokens at ``positions`` (B, C);
    ``kv_cache = {"k", "v"}``, (B, Smax, Hkv, hd) each, written in place
    at ``cache_index`` (an int or a (B,) tensor; ``cache_write``).  A
    query at position p sees the cache slots k <= p, under the causal
    and sliding-window mask (the window on a local layer only), through
    ``sdpa_reference``: slots past a query's own position hold later
    rows of its chunk or stale data."""
    B, C, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, mrope_positions, None)
    ck, cv = kv_cache["k"], kv_cache["v"]
    cache_write(ck, k, cache_index)
    cache_write(cv, v, cache_index)
    # on DTensors: query heads split into whole kv groups per device
    q = even(q, 2, cfg.num_kv_heads)
    Smax = ck.shape[1]
    k_pos = torch.arange(Smax, device=x.device)[None].expand(B, Smax)
    mask = (build_mask(positions, k_pos, cfg.sliding_window, layer_is_global)
            & (k_pos[:, None, :] <= positions[..., :, None]))
    out = sdpa_reference(q, ck, cv, mask)
    return (out.reshape(B, C, cfg.num_heads * hd) @ params["wo"],
            {"k": ck, "v": cv})


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        h = F.relu(x @ params["wi"])
    return h @ params["wo"]
