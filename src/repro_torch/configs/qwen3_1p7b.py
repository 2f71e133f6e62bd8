"""qwen3-1.7b — dense with qk-norm and GQA  [hf:Qwen/Qwen3-8B family]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (family); 1.7b config",
    num_layers=28,
    d_model=2048,
    num_heads=16, num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    remat_mode="scan",
    scan_chunks=7,
)
