"""bert_base_paper — the paper's own evaluation trunk (Bert-base scale).

Mimose's evaluation (§6) trains Bert-base (12 encoders, d=768) on SWAG /
SQuAD / GLUE-QQP with dynamic sequence lengths.  As in the reference it
is kept as a decoder-only 12-layer causal LM of the same dimensions, so
the planner sees the paper's granularity: 12 equal blocks.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="bert-base-paper",
    family="dense",
    source="Mimose paper §6 (Bert-base, 110M params)",
    num_layers=12,
    d_model=768,
    num_heads=12, num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    mlp_act="gelu",
    vocab_size=30522,
    tie_embeddings=True,
    remat_mode="unrolled",
    dtype="float32",
)
