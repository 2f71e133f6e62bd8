"""Mamba2 SSD chunk scan: two hand-written CUDA kernels for Hopper, their
plain PyTorch version, and the ``torch.autograd.Function`` around them.

Counterpart of the reference's ``kernels/ssd_scan.py``:

================  =======================  ===================
entry point       CUDA kernel              TPU kernel replaced
================  =======================  ===================
``ssd_scan``      ``ssd_scan_tc_kernel``   ``_ssd_kernel``
``ssd_scan_fma``  ``ssd_scan_fma_kernel``  ``_ssd_kernel``
================  =======================  ===================

Layout (the model's): x (B, S, H, P); dt (B, S, H); A (H,) fp32; Bm, Cm
(B, S, N); ``kv_len`` an optional (B,) int32 tensor of true lengths.  The
scan starts from a zero state; dt is zeroed at positions at or past
``kv_len``, so padding never enters the state, and chunks wholly past it
are skipped (their rows of y are zero).  Other rows at or past
``kv_len`` are unspecified.  S must be a multiple of ``chunk``
(``ops.ssd_scan`` pads).

Routing, as for flash attention: a CUDA tensor launches a kernel or
raises; a CPU tensor takes the plain version (``ref.ssd_reference``, the
sequential recurrence); a ``meta`` tensor gets a ``meta`` output.

Which kernel (``uses_tensor_cores``): the tensor-core kernel takes bf16
x, B and C with chunk 64, H a multiple of ``TC_HEAD_GROUP`` and (P, N)
one of ``TC_SHAPES``: (64, 128), the full mamba2 config's, and (50,
16), hymba's SSD heads; every other case goes to the fp32 FMA kernel
(fp32 inputs, the reference's small cases, the reduced configs).  Each
kernel has its own launch count, and each entry point raises on a case
it does not take: neither hands a call to the other.

The reference has no backward kernel for the scan: it differentiates the
jnp ``ssd_chunked`` with XLA.  So ``SSDScan`` saves its inputs and its
backward recomputes ``y`` through the port's ``ssd_chunked`` (dt masked
the same way) under autograd and returns that vector-Jacobian product.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ref import ssd_reference
from repro_torch.models.mamba2 import mask_dt, ssd_chunked

_SRC = build.CSRC / "ssd_scan.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dim P, state size N and chunk length Q the FMA kernel takes: the
# reference's SSD test cases, the reduced and the full mamba2 configs,
# and hymba's SSD heads' shape (P = 50, N = 16: the kernel tiles P at 52)
HEAD_DIMS = (16, 32, 50, 64)
STATE_SIZES = (8, 16, 32, 128)
CHUNKS = (16, 32, 64)
# what the tensor-core kernel takes (csrc/ssd_scan.cu): bf16 x, B, C;
# (P, N) of mamba2's and hymba's SSD heads; Q = 64; H a multiple of the
# heads one CTA owns
TC_SHAPES = ((64, 128), (50, 16))
TC_CHUNK, TC_HEAD_GROUP = 64, 4

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        sig = [p] * 7 + [i] * 8 + [p]
        _lib = build.load(_SRC, {"ssd_scan": sig, "ssd_scan_fma": sig})
    return _lib


def _stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _alloc(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def ssd_scan_plain(x, dt, A, Bm, Cm, kv_len=None):
    """Plain version of the kernel: y of the sequential recurrence."""
    return ssd_reference(x, dt, A, Bm, Cm, kv_len=kv_len)[0]


def uses_tensor_cores(x, Bm, chunk: int) -> bool:
    """The dispatch rule: the tensor-core kernel for bf16 x, B, C with
    (P, N) in ``TC_SHAPES``, chunk 64, H a multiple of
    ``TC_HEAD_GROUP``; the FMA kernel otherwise."""
    H, P = x.shape[2], x.shape[3]
    return (x.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16
            and (P, Bm.shape[-1]) in TC_SHAPES and chunk == TC_CHUNK
            and H % TC_HEAD_GROUP == 0)


def _kernel_args(x, dt, A, Bm, Cm, kv_len, chunk):
    """Validate the operands for either kernel; returns (B, S, H, P, N)
    and the clamped int32 lengths."""
    if not x.is_cuda:
        raise ValueError(f"the SSD kernels run on cuda tensors, not "
                         f"{x.device} (ssd_scan_fwd routes the others)")
    if x.dtype not in _DTYPE_CODE or dt.dtype not in _DTYPE_CODE:
        raise ValueError(f"the SSD kernels take float32 or bfloat16 x and "
                         f"dt, not {x.dtype} and {dt.dtype}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S == 0 or S % chunk:
        raise ValueError(f"S={S} is not a positive multiple of the chunk "
                         f"{chunk} (ops.ssd_scan pads)")
    build.check("x", x, (B, S, H, P), x.dtype, x.device)
    build.check("dt", dt, (B, S, H), dt.dtype, x.device)
    build.check("A", A, (H,), torch.float32, x.device)
    build.check("Bm", Bm, (B, S, N), x.dtype, x.device)
    build.check("Cm", Cm, (B, S, N), x.dtype, x.device)
    kvl = (torch.full((B,), S, dtype=torch.int32, device=x.device)
           if kv_len is None
           else kv_len.to(dtype=torch.int32).clamp(0, S).contiguous())
    build.check("kv_len", kvl, (B,), torch.int32, x.device)
    return (B, S, H, P, N), kvl


def _launch(name, x, dt, A, Bm, Cm, kvl, dims, chunk):
    B, S, H, P, N = dims
    y = _alloc(x.shape, x.dtype, x.device)
    err = getattr(library(), name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), kvl.data_ptr(), y.data_ptr(), B, S, H, P, N, chunk,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[dt.dtype], _stream_handle(x.device))
    build.raise_on(err, name)
    LAUNCHES[name] += 1
    return y


def ssd_scan_tc(x, dt, A, Bm, Cm, kv_len=None, chunk: int = 64):
    """The tensor-core kernel on CUDA tensors; raises on a case it does
    not take (see ``uses_tensor_cores``) or on operands whose address is
    not 16-byte aligned (``cp.async`` of 16-byte rows)."""
    dims, kvl = _kernel_args(x, dt, A, Bm, Cm, kv_len, chunk)
    if not uses_tensor_cores(x, Bm, chunk):
        B, S, H, P, N = dims
        raise ValueError(
            f"the tensor-core SSD kernel takes bf16 x/B/C, (P, N) in "
            f"{TC_SHAPES}, Q={TC_CHUNK}, H a multiple of {TC_HEAD_GROUP}; "
            f"not {x.dtype} P={P} Q={chunk} N={N} H={H}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return _launch("ssd_scan", x, dt, A, Bm, Cm, kvl, dims, chunk)


def ssd_scan_fma(x, dt, A, Bm, Cm, kv_len=None, chunk: int = 64):
    """The fp32 FMA kernel on CUDA tensors; raises on a shape it does not
    take."""
    P, N = x.shape[-1], Bm.shape[-1]
    if P not in HEAD_DIMS or N not in STATE_SIZES or chunk not in CHUNKS:
        raise ValueError(f"SSD kernel shape (P={P}, N={N}, Q={chunk}) not "
                         f"in P {HEAD_DIMS}, N {STATE_SIZES}, Q {CHUNKS}")
    dims, kvl = _kernel_args(x, dt, A, Bm, Cm, kv_len, chunk)
    return _launch("ssd_scan_fma", x, dt, A, Bm, Cm, kvl, dims, chunk)


def ssd_scan_fwd(x, dt, A, Bm, Cm, kv_len=None, chunk: int = 64):
    """A kernel (CUDA), the plain version (CPU) or a ``meta`` y: the
    tensor-core kernel for what ``uses_tensor_cores`` says, the FMA
    kernel for the rest."""
    route = build.route(x, "the SSD scan")
    if route == "plain":
        return ssd_scan_plain(x, dt, A, Bm, Cm, kv_len)
    if route == "meta":
        return torch.empty_like(x)
    if uses_tensor_cores(x, Bm, chunk):
        return ssd_scan_tc(x, dt, A, Bm, Cm, kv_len, chunk)
    return ssd_scan_fma(x, dt, A, Bm, Cm, kv_len, chunk)


class SSDScan(torch.autograd.Function):
    """The SSD scan with residuals ``(x, dt, A, Bm, Cm, kv_len)``.  The
    backward is the vector-Jacobian product of ``ssd_chunked`` on the same
    inputs (the reference differentiates that jnp formulation with XLA);
    ``kv_len`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, kv_len=None, chunk: int = 64):
        y = ssd_scan_fwd(x, dt, A, Bm, Cm, kv_len, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, kv_len)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, kv_len = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        with torch.enable_grad():
            xi, dti, Ai, Bi, Ci = inputs
            y, _ = ssd_chunked(xi, mask_dt(dti, kv_len), Ai, Bi, Ci,
                               ctx.chunk)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None, None)
