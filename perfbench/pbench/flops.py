"""Work counters: the model FLOPs of a training step and the operations
and bytes of the attention and SSD calls.

The per-layer forward counts are frozen copies of
``src/repro_torch/launch/roofline.py`` at commit e8a885f
(``_attention_flops``, ``_mlp_flops``, ``_ssm_flops``,
``ssd_scan_flops_per_position``), taken here at each sequence's true
length, so they read the same work whatever implements the step.  A
model's ``model`` dict is its configuration file's ``"model"`` entry.
"""
from __future__ import annotations

from typing import Iterable


def head_dim(m: dict) -> int:
    return int(m.get("head_dim") or m["d_model"] // m["num_heads"])


def _attention_flops(m: dict, S: int) -> float:
    """QKVO projections and causal score / value products of one layer
    over one sequence of S positions (B = 1)."""
    d, hd = m["d_model"], head_dim(m)
    attn_dim, kv_dim = m["num_heads"] * hd, m["num_kv_heads"] * hd
    proj = 2.0 * S * d * attn_dim + 2.0 * 2.0 * S * d * kv_dim \
        + 2.0 * S * attn_dim * d
    pairs = float(S) * S / 2.0
    return proj + 4.0 * m["num_heads"] * hd * pairs


def _mlp_flops(m: dict, S: int) -> float:
    ff = m.get("d_ff", 0)
    if not ff:
        return 0.0
    mult = 3.0 if m.get("mlp_act", "swiglu") == "swiglu" else 2.0
    return 2.0 * S * m["d_model"] * ff * mult


def ssd_flops_per_position(m: dict) -> float:
    """The chunked SSD scan's FLOPs per position, all heads: C B^T once
    (2QN) and per head the intra-chunk product (2QP) and the two state
    terms (4PN)."""
    H = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    Q, N, P = m["ssm_chunk"], m["ssm_state"], m["ssm_head_dim"]
    return 2.0 * Q * N + H * (2.0 * Q * P + 4.0 * P * N)


def _ssm_flops(m: dict, S: int) -> float:
    d = m["d_model"]
    d_inner = m["ssm_expand"] * d
    H = d_inner // m["ssm_head_dim"]
    N = m["ssm_state"]
    conv_dim = d_inner + 2 * N
    proj_out = 2 * d_inner + 2 * N + H
    proj = 2.0 * S * d * proj_out + 2.0 * S * d_inner * d
    conv = 2.0 * S * m["conv_kernel"] * conv_dim
    return proj + conv + S * ssd_flops_per_position(m)


def layer_fwd_flops(m: dict, S: int) -> float:
    if m["family"] == "dense":
        return _attention_flops(m, S) + _mlp_flops(m, S)
    if m["family"] == "ssm":
        return _ssm_flops(m, S) + _mlp_flops(m, S)
    raise NotImplementedError(f"no FLOP count for family {m['family']!r}")


def sequence_train_flops(m: dict, S: int) -> float:
    """Forward and backward (3x the forward) of one sequence of S true
    positions: every layer and the LM head; no embedding lookup, no
    recomputed forward."""
    fwd = m["num_layers"] * layer_fwd_flops(m, S) \
        + 2.0 * S * m["d_model"] * m["vocab_size"]
    return 3.0 * fwd


def step_train_flops(m: dict, lengths: Iterable[int]) -> float:
    return float(sum(sequence_train_flops(m, int(n)) for n in lengths))


# -- kernel calls ---------------------------------------------------------
# An attention call over q (B, H, S, hd), k, v (B, Hkv, S, hd), causal,
# at true lengths L_b.  The algorithm's work: the forward's two products
# (4 hd FLOPs a visible pair and head), the backward's five with the
# scores recomputed (10 hd).  Bytes: each input read once and each output
# written once over the true rows.

def _pairs(lengths) -> float:
    return float(sum(n * (n + 1) / 2.0 for n in lengths))


def flash_call_work(H: int, Hkv: int, hd: int, elem: int, lengths,
                    backward: bool) -> tuple:
    """(FLOPs, bytes) of one attention call (forward or backward)."""
    rows = float(sum(lengths))
    pairs = _pairs(lengths)
    q = rows * H * hd * elem
    kv = rows * Hkv * hd * elem
    lse = rows * H * 4.0
    if not backward:
        # reads q, k, v; writes o and the log-sum-exp
        return 4.0 * H * hd * pairs, q + 2 * kv + q + lse
    # reads q, k, v, o, do, lse; writes dq, dk, dv
    return 10.0 * H * hd * pairs, (q + 2 * kv + 2 * q + lse) + (q + 2 * kv)


def ssd_call_work(m: dict, elem: int, lengths, backward: bool) -> tuple:
    """(FLOPs, bytes) of one SSD scan call over x (B, S, H, P) in the
    model's dtype, dt (B, S, H) fp32, B and C (B, S, N), at true
    lengths; the backward counted as twice the forward's products."""
    rows = float(sum(lengths))
    H = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    P, N = m["ssm_head_dim"], m["ssm_state"]
    x = rows * H * P * elem
    dt = rows * H * 4.0
    bc = 2.0 * rows * N * elem
    flops = rows * ssd_flops_per_position(m)
    if not backward:
        return flops, x + dt + bc + x          # reads x, dt, B, C; writes y
    # reads x, dt, B, C, dy; writes dx, ddt, dB, dC
    return 2.0 * flops, (x + dt + bc + x) + (x + dt + bc)


def roofline_s(flops: float, nbytes: float, peak_flops: float,
               peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)
