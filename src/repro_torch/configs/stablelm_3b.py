"""stablelm-3b — dense MHA (kv=heads)  [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b (family); 3b config",
    num_layers=32,
    d_model=2560,
    num_heads=32, num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    tie_embeddings=False,
    remat_mode="scan",
    scan_chunks=8,
)
