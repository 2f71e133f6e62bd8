"""Token-choice top-k Mixture-of-Experts block (GShard-style dispatch).

Counterpart of the reference's ``models/moe.py``, used by
granite-moe-1b-a400m (32 experts, top 8) and kimi-k2 (384 experts, top
8, one shared expert).  The dispatch is the reference's capacity-based
one-hot formulation, kept exactly: tokens are cut into groups of
``_group_size`` along the sequence; each token picks its top-k experts
by router softmax, the k gates are renormalised to sum to 1; within a
group each expert takes at most ``_capacity`` (token, slot) pairs in
token-then-slot order, and the pairs past it are dropped (their gate
set to 0); dispatch and combine are dense einsums over (group, token,
expert, capacity).  The load-balance loss is
``router_aux_coef * E * sum(me * ce)`` over every token (``me``: mean
router probability per expert, ``ce``: mean count of top-k picks).

Padded positions of a bucket-padded batch are routed like real tokens,
as in the reference: they take capacity and enter the aux statistics.

The reference runs this outside any Pallas kernel, so the port computes
it with plain PyTorch einsums; the one-hot masks compare against an
``arange`` (which also runs on ``meta`` tensors for the collector).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's tree and distributions: an fp32 router ``(d, E)``
    and the experts stacked on a leading expert axis, ``wi`` / ``wg``
    ``(E, d, ff)`` and ``wo`` ``(E, ff, d)``."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {"router": dense_init(gen, d, E, torch.float32),
         "wi": (torch.randn(E, d, ff, generator=gen)
                / math.sqrt(d)).to(dtype),
         "wg": (torch.randn(E, d, ff, generator=gen)
                / math.sqrt(d)).to(dtype),
         "wo": (torch.randn(E, ff, d, generator=gen)
                / math.sqrt(ff)).to(dtype)}
    if cfg.shared_expert_d_ff:
        p["shared"] = mlp_init(gen, d, cfg.shared_expert_d_ff, cfg.mlp_act,
                               dtype)
    return p


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    cap = int(math.ceil(cfg.experts_per_token * tokens_per_group
                        / cfg.num_experts * cfg.moe_capacity_factor))
    return max(cap, cfg.experts_per_token)


def _group_size(cfg: ModelConfig, S: int) -> int:
    """Largest divisor of S not exceeding ``cfg.moe_group_size``: the
    (G, g, E, C) dispatch tensors stay linear in the token count."""
    g = min(cfg.moe_group_size, S)
    while S % g:
        g -= 1
    return g


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over a new last axis of size ``n``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class Routing(NamedTuple):
    """The router's decisions for one (B, S, d) input, in G groups of g
    tokens."""
    probs: torch.Tensor         # (G, g, E) router softmax
    gate: torch.Tensor          # (G, g, K) renormalised, 0 where dropped
    expert_idx: torch.Tensor    # (G, g, K)
    onehot: torch.Tensor        # (G, g, K, E) fp32 one-hot of expert_idx
    keep: torch.Tensor          # (G, g, K) bool: the pair got a slot
    pos: torch.Tensor           # (G, g, K) its slot, clamped to C - 1
    capacity: int               # C, slots per expert and group


def route(params, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Top-k routing of x (B, S, d) with the per-group capacity."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    g = _group_size(cfg, S)
    G = B * (S // g)
    logits = x.reshape(G, g, d).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    onehot = _one_hot(expert_idx, E)                       # (G, g, K, E)
    C = _capacity(cfg, g)
    # position of each (token, k) in its expert's per-group buffer
    flat = onehot.reshape(G, g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, K, E)
    pos = (pos * onehot).sum(-1)                           # (G, g, K)
    keep = pos < C
    gate = gate * keep.to(gate.dtype)
    pos = pos.clamp(max=C - 1).long()
    return Routing(probs, gate, expert_idx, onehot, keep, pos, C)


def moe_apply(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss (fp32 scalar))."""
    B, S, d = x.shape
    E = cfg.num_experts
    r = route(params, cfg, x)
    G, g = r.probs.shape[:2]
    xg = x.reshape(G, g, d)

    # load-balance auxiliary loss (Switch-style), over all tokens
    me = r.probs.mean(dim=(0, 1))                          # (E,)
    ce = r.onehot.sum(2).mean(dim=(0, 1))                  # (E,)
    aux = cfg.router_aux_coef * E * (me * ce).sum()

    combine = (r.gate[..., None, None] * r.onehot[..., None]
               * _one_hot(r.pos, r.capacity)[..., None, :]
               ).sum(2)                                    # (G, g, E, C)
    dispatch = (combine > 0).to(x.dtype)
    expert_in = torch.einsum("GgEC,Ggd->EGCd", dispatch, xg)
    h = (F.silu(torch.einsum("EGCd,Edf->EGCf", expert_in, params["wg"]))
         * torch.einsum("EGCd,Edf->EGCf", expert_in, params["wi"]))
    expert_out = torch.einsum("EGCf,Efd->EGCd", h, params["wo"])
    out = torch.einsum("GgEC,EGCd->Ggd", combine.to(x.dtype), expert_out)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xg, cfg.mlp_act)
    return out.reshape(B, S, d), aux
