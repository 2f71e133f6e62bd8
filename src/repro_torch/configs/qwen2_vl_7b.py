"""qwen2-vl-7b — VLM backbone with M-RoPE  [arXiv:2409.12191].

The vision frontend (ViT encoder + projector) is a stub, as in the
reference: each batch carries precomputed patch embeddings
``vision_embeds`` (B, vision_tokens, d_model), built by a
``make_batches(..., extra=...)`` function, which the decoder consumes as
prefix tokens with 3D M-RoPE positions.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191 (Qwen2-VL 7B); language decoder backbone",
    num_layers=28,
    d_model=3584,
    num_heads=28, num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_tokens=1024,       # stub frontend: 32x32 patch grid
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    remat_mode="scan",
    scan_chunks=7,
)
