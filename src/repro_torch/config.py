"""Model configuration: a copy of the reference's ``ModelConfig``.

A plain frozen dataclass, so it hashes, prints and overrides with
``dataclasses.replace``.  The field set is the reference's, so a
configuration reads the same in both packages; the port runs every
family, unrolled or in scan mode (``models/lm.py`` rejects other remat
modes).  The family predicates, the analytic parameter counts behind
the roofline's model FLOPs, and the four input shapes of the dry run
(``ShapeConfig``, ``INPUT_SHAPES``) are copied from the reference too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""                 # paper / model-card citation

    # trunk --------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    vocab_size: int = 32000

    # attention ----------------------------------------------------------
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0          # 0 -> full attention
    global_interval: int = 0         # every Nth layer is global, rest local

    # mlp ------------------------------------------------------------------
    d_ff: int = 1024
    mlp_act: str = "swiglu"          # swiglu | gelu | relu

    # moe ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512

    # ssm ------------------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4

    # hybrid -----------------------------------------------------------------
    hybrid_attn_ratio: float = 0.5

    # encoder-decoder --------------------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 0

    # vlm ------------------------------------------------------------------
    vision_tokens: int = 0

    # norms / misc -------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat_mode: str = "unrolled"     # unrolled | scan (chunked)
    scan_chunks: int = 8

    # ---------------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def attn_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim()

    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim()

    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    def uses_attention(self) -> bool:
        return self.family != "ssm"

    def subquadratic(self) -> bool:
        """True when long_500k decode is feasible (SSM/hybrid/sliding-window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def reduced(self, **over) -> "ModelConfig":
        """Reduced smoke-test variant of the same family (<=2 layers etc.)."""
        base = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32 if self.head_dim else 0,
            remat_mode="unrolled",
        )
        if self.num_experts:
            base.update(num_experts=4, experts_per_token=2,
                        moe_d_ff=min(self.moe_d_ff or 64, 64))
        if self.shared_expert_d_ff:
            base.update(shared_expert_d_ff=64)
        if self.ssm_state:
            base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.encoder_layers:
            base.update(encoder_layers=2,
                        encoder_frames=min(self.encoder_frames or 32, 32))
        if self.vision_tokens:
            base.update(vision_tokens=16)
        if self.global_interval:
            base.update(global_interval=2)
        if self.sliding_window:
            base.update(sliding_window=64)
        base.update(over)
        # keep num_kv_heads dividing num_heads
        if base["num_heads"] % base["num_kv_heads"]:
            base["num_kv_heads"] = 1
        return dataclasses.replace(self, **base)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs roofline)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim()
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d
        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o
        def mlp_params(ff: int) -> int:
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * d * ff
        def ssm_params() -> int:
            d_inner = self.ssm_expand * d
            nheads = d_inner // self.ssm_head_dim
            in_proj = d * (2 * d_inner + 2 * nheads * self.ssm_state + nheads)
            out = d_inner * d
            conv = self.conv_kernel * (d_inner + 2 * nheads * self.ssm_state)
            return in_proj + out + conv + 2 * nheads
        per_layer = 2 * d                   # two rmsnorm scales
        if self.family == "ssm":
            per_layer += ssm_params() + (mlp_params(self.d_ff) if self.d_ff else 0)
        elif self.family == "hybrid":
            per_layer += attn_params() + ssm_params() + mlp_params(self.d_ff)
        elif self.family in ("moe",):
            per_layer += attn_params()
            per_layer += self.num_experts * mlp_params(self.moe_d_ff)
            per_layer += d * self.num_experts          # router
            if self.shared_expert_d_ff:
                per_layer += mlp_params(self.shared_expert_d_ff)
        else:
            per_layer += attn_params() + mlp_params(self.d_ff)
        total += L * per_layer
        if self.encoder_layers:
            enc_layer = attn_params() + mlp_params(self.d_ff) + 2 * d
            dec_cross = attn_params() + d
            total += self.encoder_layers * enc_layer + L * dec_cross
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.mlp_act == "swiglu" else 2
        expert_p = mult * self.d_model * self.moe_d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * expert_p
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
