"""Planning constants of the H100, the per-plan-unit analytic cost
model (copied from the reference's ``launch/roofline.py``, for the
block kinds: dense, moe, ssm, hybrid, and an encoder-decoder's enc and
dec), and the dry run's roofline analysis.

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

The roofline (``analyse``, ``Roofline``) has three terms per (arch x
shape x mesh), from the counts ``launch/steps.count_setup`` takes of one
device's step:

    compute    = FLOPs per device / the GEMM rate of the model's dtype
    memory     = bytes per device / HBM_BW
    collective = collective bytes per device / NVLINK_BW

The reference divides by one TPU rate; here fp32 models divide by
``PEAK_FLOPS`` and bf16 ones by ``PEAK_FLOPS_BF16`` (``peak_flops_for``).
Collective bytes are the result bytes of every collective the step
issued, all-reduce counted twice (reduce-scatter + all-gather
equivalent traffic), as the reference counts them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

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
# HBM3 bandwidth of the H100 SXM5 80 GB, from NVIDIA's data sheet (the
# figure PERF.md's kernel bounds use)
HBM_BW = 3.35e12
# NVLink 4 on the H100 SXM5: 900 GB/s per card both ways, 450e9 bytes/s
# each way, from NVIDIA's data sheet.  One card cannot measure it: the
# chip runs of this repository have one NVIDIA H100 80GB HBM3.
NVLINK_BW = 450e9


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
    return PEAK_FLOPS / peak_flops_for(dtype)


def plan_unit_flops(lm, batch) -> np.ndarray:
    """Per-plan-unit forward FLOPs vector for ``lm`` at this batch's
    geometry, aligned with the planner's byte vectors."""
    return np.array([unit_fwd_flops(lm.cfg, m["kind"], batch=m["batch"],
                                    seq=m["seq"], layers=m["layers"],
                                    is_global=m["is_global"],
                                    enc_frames=m.get("enc_frames", 0))
                     for m in lm.plan_unit_meta(batch)], dtype=np.float64)


# ---------------------------------------------------------------------------
# the dry run's roofline
# ---------------------------------------------------------------------------

def peak_flops_for(dtype) -> float:
    """The GEMM rate the compute term divides by: ``PEAK_FLOPS_BF16``
    for a bf16 (or fp16) model, ``PEAK_FLOPS`` for fp32.  Reads the
    constants when called."""
    name = str(dtype).replace("torch.", "")
    return PEAK_FLOPS_BF16 if name in ("bfloat16", "float16") else PEAK_FLOPS


def collective_bytes(records: Iterable[Tuple[str, float]]
                     ) -> Dict[str, float]:
    """Per-device bytes moved by each collective kind, from the step's
    recorded ``(kind, result bytes)`` pairs (kinds named as the
    reference's HLO: all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute)."""
    out: Dict[str, float] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0.0) + float(nbytes)
    return out


def collective_total(coll: Dict[str, float]) -> float:
    """The collective term's bytes: all-reduce traffic ~ 2x its payload
    (reduce-scatter + all-gather phases)."""
    return sum(v * (2.0 if k == "all-reduce" else 1.0)
               for k, v in coll.items())


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, float]
    temp_bytes_per_dev: float
    arg_bytes_per_dev: float
    model_flops: float              # 6 * N_active * tokens (global)
    peak_flops: float               # the model dtype's GEMM rate

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs aggregated over devices)."""
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_bound_s(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """MFU if the step ran exactly at the dominant roofline term."""
        t = self.step_time_bound_s
        if not t:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_ms": round(self.t_compute * 1e3, 3),
            "t_memory_ms": round(self.t_memory * 1e3, 3),
            "t_collective_ms": round(self.t_collective * 1e3, 3),
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": round(self.useful_flops_ratio, 3),
            "mfu_bound": round(self.mfu_bound, 3),
            "temp_gib_per_dev": round(self.temp_bytes_per_dev / 2**30, 2),
            "arg_gib_per_dev": round(self.arg_bytes_per_dev / 2**30, 2),
        }


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one token/seq."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch          # one new token per sequence
        return 2.0 * n * tokens              # forward only
    tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def analyse(counts, *, arch: str, shape_cfg, cfg, mesh_name: str,
            chips: int) -> Roofline:
    """The roofline of one device's step from ``counts`` (a
    ``launch.steps.StepCounts``)."""
    coll = collective_bytes(counts.collectives)
    return Roofline(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_dev=float(counts.flops),
        bytes_per_dev=float(counts.bytes),
        coll_bytes_per_dev=collective_total(coll),
        coll_breakdown=coll,
        temp_bytes_per_dev=float(counts.temp_bytes),
        arg_bytes_per_dev=float(counts.arg_bytes),
        model_flops=model_flops_for(cfg, shape_cfg),
        peak_flops=peak_flops_for(cfg.dtype),
    )
