"""Public wrapper around the flash-attention kernels in the model's
layout (counterpart of the reference's ``kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import LAUNCHES, FlashAttention

__all__ = ["LAUNCHES", "flash_attention", "reset_launches"]


def flash_attention(q, k, v, kv_len=None, *, causal: bool = True,
                    window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd) -> (B, S, H, hd).

    Model layout; transposed to the kernels' (B, H, S, hd) here.
    ``kv_len``: optional (B,) int32 true lengths of a bucket-padded
    batch — padded keys are masked and fully padded tiles skipped.
    """
    def kernel_layout(t):
        return t.transpose(1, 2).contiguous()
    o = FlashAttention.apply(kernel_layout(q), kernel_layout(k),
                             kernel_layout(v), kv_len, causal, window)
    return o.transpose(1, 2)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
