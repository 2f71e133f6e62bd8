"""Model configuration: a copy of the reference's ``ModelConfig``.

A plain frozen dataclass, so it hashes, prints and overrides with
``dataclasses.replace``.  The field set is the reference's, so a
configuration reads the same in both packages; the port runs every
family, unrolled or in scan mode (``models/lm.py`` rejects other remat
modes).
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
