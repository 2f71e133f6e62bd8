"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8
[arXiv:2501.kimi2] (paper-table scale)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2 (Kimi K2); 1T total / 32B active",
    num_layers=61,
    d_model=7168,
    num_heads=64, num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    moe_d_ff=2048,
    num_experts=384,
    experts_per_token=8,
    shared_expert_d_ff=2048,  # one always-on shared expert
    vocab_size=163840,
    tie_embeddings=False,
    remat_mode="scan",
    scan_chunks=8,
)
