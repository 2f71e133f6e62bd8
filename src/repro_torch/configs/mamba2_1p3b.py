"""mamba2-1.3b — SSD (state-space duality), attention-free  [arXiv:2405.21060]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060 (Mamba-2, SSD); 1.3b config",
    num_layers=48,
    d_model=2048,
    d_ff=0,                  # attention-free, no MLP blocks
    vocab_size=50280,
    num_heads=1, num_kv_heads=1,   # unused (no attention)
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    # chunk length trades intra-chunk matmul efficiency against the
    # (B, S, Q, H) decay-matrix working set the plain path materialises;
    # the kernel stages one chunk at a time in shared memory
    ssm_chunk=64,
    conv_kernel=4,
    tie_embeddings=True,
    remat_mode="scan",
    scan_chunks=8,
)
