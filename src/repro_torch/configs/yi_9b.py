"""yi-9b — llama-architecture dense with GQA kv=4  [arXiv:2403.04652]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652 (Yi); 9B config",
    num_layers=48,
    d_model=4096,
    num_heads=32, num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat_mode="scan",
    scan_chunks=8,
)
