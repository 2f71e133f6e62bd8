"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16, num_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    num_experts=32,
    experts_per_token=8,
    vocab_size=49155,
    tie_embeddings=True,
    remat_mode="scan",
    scan_chunks=8,
)
