"""Planning constants of the H100 and the per-plan-unit analytic cost
model (copied from the reference's ``launch/roofline.py``, for the
block kinds: dense, moe, ssm, hybrid, and an encoder-decoder's enc and
dec).

The simulator, scheduler, solver and planners bind the constants below
at import, as the reference binds its own.  They price a plan's
overhead in seconds: recompute FLOPs over ``PEAK_FLOPS``, host traffic
over ``PCIE_BW``, and ``(k - 1) x MICROBATCH_OVERHEAD_S`` for a k-way
gradient-accumulation split.  A model's recompute runs at the GEMM rate
of its dtype, so a planner hands the simulator FLOPs scaled by
``recompute_scale(dtype)`` = ``PEAK_FLOPS`` over that rate (1 for fp32,
``PEAK_FLOPS / PEAK_FLOPS_BF16`` for bf16).  Each constant was measured
by ``repro_torch.launch.calibrate`` (run by ``chip_smoke.py``).

Forward FLOPs of one schedulable unit at a given batch geometry.
Rematerialising a unit re-runs exactly this forward, so these numbers
are the recompute cost the cost-aware scheduler scores against.
"""
from __future__ import annotations

import numpy as np

# Measured by chip_smoke.py (launch/calibrate.py) on an NVIDIA H100 80GB
# HBM3, 700.00 W power limit; PEAK_FLOPS and PCIE_BW in the chip run
# PERF.md calls C3 (its planners-path findings give the spread over the
# other runs).
# fp32 GEMM rate with TF32 off (as the bert path runs), torch.mm at the
# bert MLP shape 3328 x 768 x 3072 (the data sheet's fp32 peak: 67e12)
PEAK_FLOPS = 4.4837e13
# bf16 GEMM rate, torch.mm at the hymba MLP shape 3584 x 1600 x 5504 (the
# data sheet's dense bf16 tensor-core peak: 989e12); it prices the
# recompute of bf16 models (mamba2, granite, hymba).  Measured by
# chip_smoke.py (launch/calibrate.py) on an NVIDIA H100 80GB HBM3,
# 700.00 W: the run PERF.md calls PR 18 H2.
PEAK_FLOPS_BF16 = 6.7403e14
# one pinned host <-> device round trip of 256 MiB, bytes per direction
# over the round trip's time per direction
PCIE_BW = 5.4387e10
# a warm full-width bert_base_paper step (squad lengths, B = 8, S = 448)
# at k = 2 minus the same step at k = 1 under the same plan, difference
# of the medians of 12 steps each: the median of five runs (C3, F, F2,
# F3, G1: 39.3 to 74.1 ms).  About 11 ms of it is device time, the rest
# the host's dispatch of 2,600 more kernels, so it follows the host's
# load more than the card.
MICROBATCH_OVERHEAD_S = 0.063917


def _attention_flops(cfg, B: int, S: int, *, causal: bool = True,
                     is_global: bool = True, kv_seq: int = 0) -> float:
    """QKVO projections + score/value matmuls for one attention layer;
    ``kv_seq`` > 0 is cross attention over that many keys (k, v
    projected from the encoder's stream)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    Sk = kv_seq or S
    proj = 2.0 * B * S * d * cfg.attn_dim()            # q
    proj += 2.0 * 2.0 * B * Sk * d * cfg.kv_dim()      # k, v
    proj += 2.0 * B * S * cfg.attn_dim() * d           # o
    W = cfg.sliding_window
    if kv_seq:
        pairs = float(S) * Sk                          # cross: every key
    elif not is_global and W > 0:
        pairs = float(S) * min(W, S)                   # banded
    elif causal:
        pairs = float(S) * S / 2.0
    else:
        pairs = float(S) * S                           # bidirectional
    return proj + 4.0 * B * cfg.num_heads * hd * pairs


def _mlp_flops(cfg, B: int, S: int, d_ff: int = 0) -> float:
    ff = d_ff or cfg.d_ff
    if not ff:
        return 0.0
    mult = 3.0 if cfg.mlp_act == "swiglu" else 2.0
    return 2.0 * B * S * cfg.d_model * ff * mult


def _moe_flops(cfg, B: int, S: int) -> float:
    router = 2.0 * B * S * cfg.d_model * cfg.num_experts
    experts = cfg.experts_per_token * _mlp_flops(cfg, B, S, cfg.moe_d_ff)
    shared = (_mlp_flops(cfg, B, S, cfg.shared_expert_d_ff)
              if cfg.shared_expert_d_ff else 0.0)
    return router + experts + shared


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
                   is_global: bool = True, enc_frames: int = 0) -> float:
    """Analytic forward FLOPs of one plan unit (``layers`` blocks of
    ``kind`` at geometry (batch, seq); a ``dec`` block's cross attention
    over ``enc_frames`` keys)."""
    B, S = int(batch), int(seq)
    if kind == "enc":
        per = (_attention_flops(cfg, B, S, causal=False)
               + _mlp_flops(cfg, B, S))
    elif kind == "dec":
        per = (_attention_flops(cfg, B, S, is_global=is_global)
               + _attention_flops(cfg, B, S, kv_seq=enc_frames or S)
               + _mlp_flops(cfg, B, S))
    elif kind == "ssm":
        per = _ssm_flops(cfg, B, S) + _mlp_flops(cfg, B, S)
    elif kind == "dense":
        per = (_attention_flops(cfg, B, S, is_global=is_global)
               + _mlp_flops(cfg, B, S))
    elif kind == "moe":
        per = (_attention_flops(cfg, B, S, is_global=is_global)
               + _moe_flops(cfg, B, S))
    elif kind == "hybrid":
        per = (_attention_flops(cfg, B, S, is_global=is_global)
               + _ssm_flops(cfg, B, S) + _mlp_flops(cfg, B, S))
    else:
        raise NotImplementedError(f"unit kind {kind!r} is not ported")
    return float(layers) * per


def recompute_scale(dtype) -> float:
    """``PEAK_FLOPS`` over the GEMM rate of ``dtype`` (a torch dtype or
    its name): what a FLOPs vector is multiplied by so that dividing it
    by ``PEAK_FLOPS`` prices the recompute at the model's own rate.
    Reads the constants when called."""
    name = str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return PEAK_FLOPS / PEAK_FLOPS_BF16
    return 1.0


def plan_unit_flops(lm, batch) -> np.ndarray:
    """Per-plan-unit forward FLOPs vector for ``lm`` at this batch's
    geometry, aligned with the planner's byte vectors."""
    return np.array([unit_fwd_flops(lm.cfg, m["kind"], batch=m["batch"],
                                    seq=m["seq"], layers=m["layers"],
                                    is_global=m["is_global"],
                                    enc_frames=m.get("enc_frames", 0))
                     for m in lm.plan_unit_meta(batch)], dtype=np.float64)
