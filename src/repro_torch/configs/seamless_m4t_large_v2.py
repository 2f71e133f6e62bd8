"""seamless-m4t-large-v2 — multimodal encoder-decoder backbone
[arXiv:2308.11596].

The speech frontend (mel-spectrogram + conformer conv feature extractor)
is a stub, as in the reference: each batch carries precomputed frame
embeddings ``frames`` (B, frames, d_model), built by a
``make_batches(..., extra=...)`` function and consumed by the transformer
encoder.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    source="arXiv:2308.11596 (SeamlessM4T large v2); text decoder + speech encoder backbone",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    encoder_frames=4096,      # default stub frame count (overridden per shape)
    d_model=1024,
    num_heads=16, num_kv_heads=16,
    d_ff=8192,
    mlp_act="gelu",
    vocab_size=256206,
    tie_embeddings=True,
    remat_mode="unrolled",    # enc+dec planned jointly per block
)
