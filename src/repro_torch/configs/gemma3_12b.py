"""gemma3-12b — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family, 12b trunk]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-12b-pt (5:1 local:global sliding window)",
    num_layers=48,
    d_model=3840,
    num_heads=16, num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_interval=6,        # every 6th layer global, 5 local before it
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    remat_mode="scan",
    scan_chunks=8,            # 6 layers/chunk, aligned with the 5:1 pattern
)
