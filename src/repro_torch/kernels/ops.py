"""Public wrappers around the kernels in the model's layout (counterpart
of the reference's ``kernels/ops.py``), and the launch counts of every
kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.offload_dma import dma_copy
from repro_torch.kernels.ssd_scan import SSDScan

__all__ = ["LAUNCHES", "flash_attention", "reset_launches",
           "residual_dma_copy", "ssd_scan"]


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


def residual_dma_copy(x, *, chunk_elems: int = 1 << 15):
    """Stage a residual checkpoint through the double-buffered copy
    kernel: chunk ``i+1``'s fetch overlaps chunk ``i``'s drain.
    Value-identical to ``x``."""
    return dma_copy(x.contiguous(), chunk_elems)


def ssd_scan(x, dt, A, Bm, Cm, kv_len=None, *, chunk: int = 64,
             chunks_per_block: int = 1):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N) ->
    y (B, S, H, P), from a zero state.

    Pads S to a ``chunk * chunks_per_block`` multiple and slices back, as
    the reference does (each kernel walks all of a sequence's chunks in
    one loop, so ``chunks_per_block`` only sets the padding span here).
    ``kv_len``: optional (B,) int32 true lengths — contributions past a
    sequence's length never enter the state, and chunks wholly inside
    the padding never run.
    """
    B, S = x.shape[:2]
    pad = (-S) % (chunk * chunks_per_block)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), S, dtype=torch.int32, device=x.device)
    y = SSDScan.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                      Bm.contiguous(), Cm.contiguous(), kv_len, chunk)
    return y[:, :S]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
