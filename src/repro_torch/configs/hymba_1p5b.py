"""hymba-1.5b — hybrid parallel attention + mamba heads  [arXiv:2411.13676]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676 (Hymba 1.5B)",
    num_layers=32,
    d_model=1600,
    num_heads=25, num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,      # most layers use SWA; every 8th is global
    global_interval=8,
    ssm_state=16,
    ssm_head_dim=50,          # d_inner 3200 / 64 heads
    ssm_expand=2,
    ssm_chunk=64,
    tie_embeddings=True,
    remat_mode="scan",
    scan_chunks=8,
)
