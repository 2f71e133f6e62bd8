"""Per-plan-unit analytic cost model (copied from the reference's
``launch/roofline.py``, dense subset).

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


def unit_fwd_flops(cfg, kind: str, *, batch: int, seq: int, layers: int = 1,
                   is_global: bool = True) -> float:
    """Analytic forward FLOPs of one plan unit (``layers`` dense blocks
    at geometry (batch, seq))."""
    if kind != "dense":
        raise NotImplementedError(f"unit kind {kind!r} is not ported")
    B, S = int(batch), int(seq)
    per = (_attention_flops(cfg, B, S, is_global=is_global)
           + _mlp_flops(cfg, B, S))
    return float(layers) * per


def plan_unit_flops(lm, batch) -> np.ndarray:
    """Per-plan-unit forward FLOPs vector for ``lm`` at this batch's
    geometry, aligned with the planner's byte vectors."""
    return np.array([unit_fwd_flops(lm.cfg, m["kind"], batch=m["batch"],
                                    seq=m["seq"], layers=m["layers"],
                                    is_global=m["is_global"])
                     for m in lm.plan_unit_meta(batch)], dtype=np.float64)
