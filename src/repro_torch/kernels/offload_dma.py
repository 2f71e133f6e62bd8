"""Double-buffered copy: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of the reference's ``kernels/offload_dma.py``:

==============  ===================  ====================
wrapper here    CUDA kernel          TPU kernel replaced
==============  ===================  ====================
``dma_copy``    ``dma_copy_kernel``  ``_dma_copy_kernel``
==============  ===================  ====================

The array is walked in ``chunk_elems`` chunks; each chunk streams through
an eight-slot shared-memory ring fed and drained by TMA bulk copies, the
fetches of the next tiles in flight while one drains
(``csrc/offload_dma.cu``).  The result equals the
input: the schedule, not the data, is the product.  Any dtype copies
(the kernel moves bytes).

Routing, as for the other kernels: a CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version (the reference's flatten,
zero-pad to whole chunks, copy, unpad); a ``meta`` tensor gets a
``meta`` copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

_SRC = build.CSRC / "offload_dma.cu"

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        _lib = build.load(_SRC, {"dma_copy": [p, p, ll, ll, p]})
    return _lib


def _stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _alloc(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _chunk(n: int, chunk_elems: int) -> int:
    return int(min(chunk_elems, max(n, 1)))


def dma_copy_plain(x: torch.Tensor, chunk_elems: int = 1 << 15):
    """Plain version: flatten, zero-pad to whole chunks, copy, unpad."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    chunk = _chunk(n, chunk_elems)
    pad = (-n) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(-1, chunk).clone()
    return chunks.reshape(-1)[:n].reshape(x.shape)


def dma_copy(x: torch.Tensor, chunk_elems: int = 1 << 15) -> torch.Tensor:
    """A copy of ``x`` (same shape and dtype) through the kernel's
    double-buffered schedule, ``chunk_elems`` elements per chunk."""
    route = build.route(x, "the DMA copy")
    if route == "plain":
        return dma_copy_plain(x, chunk_elems)
    if route == "meta":
        return torch.empty_like(x)
    if chunk_elems < 1:
        raise ValueError(f"chunk_elems must be positive, not {chunk_elems}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = _alloc(x.shape, x.dtype, x.device)
    n = x.numel()
    if n == 0:
        return out
    err = library().dma_copy(x.data_ptr(), out.data_ptr(),
                             n * x.element_size(),
                             _chunk(n, chunk_elems) * x.element_size(),
                             _stream_handle(x.device))
    build.raise_on(err, "dma_copy")
    LAUNCHES["dma_copy"] += 1
    return out
