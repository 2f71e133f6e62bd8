"""Per-plan-unit analytic cost model (copied from the reference's
``launch/roofline.py``, dense and ssm kinds).

Forward FLOPs of one schedulable unit at a given batch geometry.
Rematerialising a unit re-runs exactly this forward, so these numbers
are the recompute cost the cost-aware scheduler scores against.  The
scheduler uses only their ratios, so no device peak rate is needed.
"""
from __future__ import annotations

import numpy as np


def _attention_flops(cfg, B: int, S: int, *, is_global: bool = True) -> float:
    """QKVO projections + score/value matmuls for one causal attention
    layer."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    proj = 2.0 * B * S * d * cfg.attn_dim()            # q
    proj += 2.0 * 2.0 * B * S * d * cfg.kv_dim()       # k, v
    proj += 2.0 * B * S * cfg.attn_dim() * d           # o
    W = cfg.sliding_window
    if not is_global and W > 0:
        pairs = float(S) * min(W, S)                   # banded
    else:
        pairs = float(S) * S / 2.0
    return proj + 4.0 * B * cfg.num_heads * hd * pairs


def _mlp_flops(cfg, B: int, S: int) -> float:
    if not cfg.d_ff:
        return 0.0
    mult = 3.0 if cfg.mlp_act == "swiglu" else 2.0
    return 2.0 * B * S * cfg.d_model * cfg.d_ff * mult


def _ssm_flops(cfg, B: int, S: int) -> float:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    conv_dim = d_inner + 2 * N
    proj_out = 2 * d_inner + 2 * N + H
    proj = 2.0 * B * S * d * proj_out + 2.0 * B * S * d_inner * d
    conv = 2.0 * B * S * cfg.conv_kernel * conv_dim
    # chunked SSD: intra-chunk (Q,Q) matmuls + inter-chunk state terms
    scan = B * S * ssd_scan_flops_per_position(cfg)
    return proj + conv + scan


def ssd_scan_flops_per_position(cfg) -> float:
    """The chunked SSD scan's FLOPs per position, all heads: C B^T once
    (2QN) and per head the intra-chunk product (2QP) and the two state
    terms (4PN)."""
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    Q, N, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_head_dim
    return 2.0 * Q * N + H * (2.0 * Q * P + 4.0 * P * N)


def unit_fwd_flops(cfg, kind: str, *, batch: int, seq: int, layers: int = 1,
                   is_global: bool = True) -> float:
    """Analytic forward FLOPs of one plan unit (``layers`` blocks of
    ``kind`` at geometry (batch, seq))."""
    B, S = int(batch), int(seq)
    if kind == "ssm":
        per = _ssm_flops(cfg, B, S) + _mlp_flops(cfg, B, S)
    elif kind == "dense":
        per = (_attention_flops(cfg, B, S, is_global=is_global)
               + _mlp_flops(cfg, B, S))
    else:
        raise NotImplementedError(f"unit kind {kind!r} is not ported")
    return float(layers) * per


def plan_unit_flops(lm, batch) -> np.ndarray:
    """Per-plan-unit forward FLOPs vector for ``lm`` at this batch's
    geometry, aligned with the planner's byte vectors."""
    return np.array([unit_fwd_flops(lm.cfg, m["kind"], batch=m["batch"],
                                    seq=m["seq"], layers=m["layers"],
                                    is_global=m["is_global"])
                     for m in lm.plan_unit_meta(batch)], dtype=np.float64)
