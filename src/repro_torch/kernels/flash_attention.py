"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of the reference's ``kernels/flash_attention.py``:

=====================  ============================  =====================
wrapper here           CUDA kernel                   TPU kernel replaced
=====================  ============================  =====================
``flash_fwd``          ``flash_fwd_tc_kernel``       ``_flash_kernel``
``flash_fwd_fma``      ``flash_fwd_fma_kernel``      ``_flash_kernel``
``flash_bwd_dq``       ``flash_bwd_dq_tc_kernel``    ``_flash_bwd_dq_kernel``
``flash_bwd_dq_fma``   ``flash_bwd_dq_fma_kernel``   ``_flash_bwd_dq_kernel``
``flash_bwd_dkv``      ``flash_bwd_dkv_tc_kernel``   ``_flash_bwd_dkv_kernel``
``flash_bwd_dkv_fma``  ``flash_bwd_dkv_fma_kernel``  ``_flash_bwd_dkv_kernel``
=====================  ============================  =====================

Layout: q (B, H, S, hd); k, v (B, Hkv, S, hd); GQA through the kv head
``h // (H // Hkv)``.  ``kv_len`` is an optional (B,) int32 tensor of true
lengths: keys at or past it are masked and fully padded tiles skipped.
Output rows at or past ``kv_len`` are unspecified; dk and dv are exactly
zero there.

Which kernel: the forward, dq and dk/dv kernels on the tensor cores
(bf16 hi/lo products, ``csrc/flash_attention.cu``) take every case these
wrappers take -- fp32 and bf16, head dims ``HEAD_DIMS``, GQA, causal or
not, window, ragged -- and ``flash_bwd`` and ``FlashAttention`` launch
them; bf16 at head dim 256 runs all three on Hopper's ``wgmma`` and
TMA (``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``, ``csrc/flash_bwd_wgmma.cuh``; one CTA
of ``WGMMA_THREADS``) behind the same entry points and counts.
The fp32 FMA kernels they replaced are reached only through
their own entry points ``flash_fwd_fma``, ``flash_bwd_dq_fma`` and
``flash_bwd_dkv_fma`` (a second fp32 witness on the card), at the head
dims ``FMA_HEAD_DIMS`` only.  Each kernel
has its own launch count in ``LAUNCHES``, and no entry point hands a
call to another kernel.  The tensor-core kernels read 16-byte pieces, so
every entry point copies an input whose address is not 16-byte aligned
to one that is before the launch.

Routing: for a CUDA tensor a wrapper launches its kernel or raises — it
never falls back.  For a CPU tensor it runs the plain version beside it.
For a ``meta`` tensor it returns ``meta`` outputs of the kernel's shapes
(the collector traces blocks on ``meta`` to count saved residuals).

The kernels are built from ``csrc/flash_attention.cu`` with ``nvcc`` at
first use into ``build/repro_torch/`` at the repository root and loaded
with ``ctypes`` (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.ref import attention_mask

NEG_INF = float(torch.finfo(torch.float32).min)

_SRC = build.CSRC / "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dims the tensor-core kernels take, and the FMA kernels
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
FMA_HEAD_DIMS = (16, 32, 64, 128)
# threads per CTA: the wgmma kernels' two warpgroups, the mma.sync
# kernels' four warps
WGMMA_THREADS, MMA_THREADS = 256, 128
# C entry point -> number of pointer arguments
_ENTRY_POINTS = {"flash_fwd": 6, "flash_fwd_fma": 6, "flash_bwd_dq": 8,
                 "flash_bwd_dq_fma": 8, "flash_bwd_dkv": 9,
                 "flash_bwd_dkv_fma": 9}

_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i] * 7 + [ctypes.c_float, i, p]
        sigs = {name: [p] * n_ptrs + tail
                for name, n_ptrs in _ENTRY_POINTS.items()}
        sigs["flash_kernel_config"] = [i, i, i, ctypes.POINTER(i)]
        _lib = build.load(_SRC, sigs)
    return _lib


def kernel_config(entry: str, hd: int, dtype: torch.dtype) -> dict:
    """The launch configuration of the kernel that ``entry``
    (``flash_fwd``, ``flash_bwd_dq`` or ``flash_bwd_dkv``) runs at head
    dim ``hd`` in ``dtype``: threads per CTA, dynamic shared memory in
    bytes, registers and local memory a thread.  Launches nothing;
    raises if the library refuses or reports another thread count than
    the entry's kernel has: ``WGMMA_THREADS`` for bf16 at head dim 256
    (the wgmma kernels), ``MMA_THREADS`` otherwise."""
    which = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").index(entry)
    info = (ctypes.c_int * 4)()
    build.raise_on(library().flash_kernel_config(which, hd,
                                                 _DTYPE_CODE[dtype], info),
                   "flash_kernel_config")
    got = dict(zip(("threads", "smem", "regs", "local"), info))
    wgmma = dtype == torch.bfloat16 and hd == 256
    want = WGMMA_THREADS if wgmma else MMA_THREADS
    if got["threads"] != want:
        raise RuntimeError(f"{entry} at hd {hd} {dtype} runs a kernel of "
                           f"{got['threads']} threads, not {want}")
    return got


def _stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _alloc(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _kernel_args(name, q, k, v, kv_len) -> Tuple[tuple, torch.Tensor]:
    """Validate the common operands of the launch of ``name``; returns
    the integer arguments and the clamped int32 lengths."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take float32 or bfloat16, "
                         f"not {q.dtype}")
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    dims = FMA_HEAD_DIMS if name.endswith("_fma") else HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"{name}: head dim {hd} not in {dims}")
    if S == 0 or Hkv == 0 or H % Hkv:
        raise ValueError(f"bad heads/length: H={H} Hkv={Hkv} S={S}")
    build.check("q", q, (B, H, S, hd), q.dtype, q.device)
    build.check("k", k, (B, Hkv, S, hd), q.dtype, q.device)
    build.check("v", v, (B, Hkv, S, hd), q.dtype, q.device)
    kvl = resolve_kv_len(kv_len, B, S, q.device)
    build.check("kv_len", kvl, (B,), torch.int32, q.device)
    return (B, H, Hkv, S, hd), kvl


def resolve_kv_len(kv_len, B: int, S: int, device) -> torch.Tensor:
    """Normalise ``kv_len`` to a clamped (B,) int32 tensor (None -> S).
    A given ``kv_len`` stays on its device (the caller checks it)."""
    if kv_len is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return kv_len.to(dtype=torch.int32).clamp(0, S).contiguous()


# ---------------------------------------------------------------------------
# plain versions (same function as each kernel, computed densely in fp32)
# ---------------------------------------------------------------------------

def _dense(q, k, kv_len, causal, window, rows_valid=False):
    """Scores, mask and kv-head expansion shared by the plain versions."""
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    kq = k.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * (1.0 / math.sqrt(hd))
    mask = attention_mask(S, S, kv_len, causal=causal, window=window,
                          device=q.device)
    if rows_valid and kv_len is not None:
        qpos = torch.arange(S, device=q.device)[None, :, None]
        mask = mask & (qpos < kv_len[:, None, None])
    return s, mask[:, None], kq, group


def flash_fwd_plain(q, k, v, kv_len=None, causal=True, window=0):
    """Plain version of K1: (o, lse) with the kernel's empty-row
    convention (o = 0, lse = NEG_INF + log(1e-30))."""
    s, mask, _, group = _dense(q, k, kv_len, causal, window)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(-1).clamp_min(1e-30)
    vq = v.float().repeat_interleave(group, dim=1)
    o = (p @ vq) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, kv_len=None, causal=True,
                       window=0):
    """Plain version of K2: dq from the saved residuals."""
    s, mask, kq, group = _dense(q, k, kv_len, causal, window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      v.float().repeat_interleave(group, dim=1))
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    return (ds @ kq).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, kv_len=None, causal=True,
                        window=0):
    """Plain version of K3: (dk, dv) per kv head, masked also by
    ``q < kv_len`` so padded keys get exactly zero."""
    s, mask, _, group = _dense(q, k, kv_len, causal, window, rows_valid=True)
    B, H, S, hd = q.shape
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof,
                      v.float().repeat_interleave(group, dim=1))
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(hd))
    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ q.float()
    Hkv = k.shape[1]
    dk = dk.reshape(B, Hkv, group, S, hd).sum(2)
    dv = dv.reshape(B, Hkv, group, S, hd).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned address."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, tensors, dims, causal, window, q) -> None:
    """One launch of the C entry point ``name`` on the tensors' pointers;
    raises if it was refused, counts it if not."""
    err = getattr(library(), name)(
        *(t.data_ptr() for t in tensors), *dims, int(causal), int(window),
        1.0 / math.sqrt(q.shape[-1]), _DTYPE_CODE[q.dtype],
        _stream_handle(q.device))
    build.raise_on(err, name)
    LAUNCHES[name] += 1


def _fwd(name, q, k, v, kv_len, causal, window):
    route = build.route(q, "flash attention")
    if route == "plain":
        return flash_fwd_plain(q, k, v, kv_len, causal, window)
    B, H, S, hd = q.shape
    if route == "meta":
        return (torch.empty_like(q),
                torch.empty((B, H, S), dtype=torch.float32, device="meta"))
    dims, kvl = _kernel_args(name, q, k, v, kv_len)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = _alloc(q.shape, q.dtype, q.device)
    lse = _alloc((B, H, S), torch.float32, q.device)
    _launch(name, (q, k, v, kvl, o, lse), dims, causal, window, q)
    return o, lse


def flash_fwd(q, k, v, kv_len=None, causal: bool = True, window: int = 0):
    """K1 on the tensor cores: returns (o in q's dtype, lse (B, H, S)
    fp32)."""
    return _fwd("flash_fwd", q, k, v, kv_len, causal, window)


def flash_fwd_fma(q, k, v, kv_len=None, causal: bool = True,
                  window: int = 0):
    """K1's fp32 FMA kernel: the same function as ``flash_fwd``."""
    return _fwd("flash_fwd_fma", q, k, v, kv_len, causal, window)


def _bwd_args(name, q, k, v, do, lse, delta, kv_len):
    dims, kvl = _kernel_args(name, q, k, v, kv_len)
    B, H, S, hd = q.shape
    build.check("do", do, q.shape, q.dtype, q.device)
    build.check("lse", lse, (B, H, S), torch.float32, q.device)
    build.check("delta", delta, (B, H, S), torch.float32, q.device)
    return dims, kvl


def _dq(name, q, k, v, do, lse, delta, kv_len, causal, window):
    route = build.route(q, "flash attention")
    if route == "plain":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, kv_len, causal,
                                  window)
    if route == "meta":
        return torch.empty_like(q)
    dims, kvl = _bwd_args(name, q, k, v, do, lse, delta, kv_len)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dq = _alloc(q.shape, q.dtype, q.device)
    _launch(name, (q, k, v, do, lse, delta, kvl, dq), dims, causal, window,
            q)
    return dq


def flash_bwd_dq(q, k, v, do, lse, delta, kv_len=None, causal: bool = True,
                 window: int = 0):
    """K2 on the tensor cores: dq from the residuals and ``delta =
    rowsum(do * o)``."""
    return _dq("flash_bwd_dq", q, k, v, do, lse, delta, kv_len, causal,
               window)


def flash_bwd_dq_fma(q, k, v, do, lse, delta, kv_len=None,
                     causal: bool = True, window: int = 0):
    """K2's fp32 FMA kernel: the same function as ``flash_bwd_dq``."""
    return _dq("flash_bwd_dq_fma", q, k, v, do, lse, delta, kv_len, causal,
               window)


def _dkv(name, q, k, v, do, lse, delta, kv_len, causal, window):
    route = build.route(q, "flash attention")
    if route == "plain":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, kv_len, causal,
                                   window)
    if route == "meta":
        return torch.empty_like(k), torch.empty_like(v)
    dims, kvl = _bwd_args(name, q, k, v, do, lse, delta, kv_len)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    dk = _alloc(k.shape, k.dtype, k.device)
    dv = _alloc(v.shape, v.dtype, v.device)
    _launch(name, (q, k, v, do, lse, delta, kvl, dk, dv), dims, causal,
            window, q)
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, kv_len=None, causal: bool = True,
                  window: int = 0):
    """K3 on the tensor cores: (dk, dv) per kv head."""
    return _dkv("flash_bwd_dkv", q, k, v, do, lse, delta, kv_len, causal,
                window)


def flash_bwd_dkv_fma(q, k, v, do, lse, delta, kv_len=None,
                      causal: bool = True, window: int = 0):
    """K3's fp32 FMA kernel: the same function as ``flash_bwd_dkv``."""
    return _dkv("flash_bwd_dkv_fma", q, k, v, do, lse, delta, kv_len, causal,
                window)


def flash_bwd(q, k, v, o, lse, do, kv_len=None, causal: bool = True,
              window: int = 0):
    """K2 and K3 (on the tensor cores): returns (dq, dk, dv), dk/dv per kv
    head.  ``delta = rowsum(do * o)`` is a torch reduction outside the
    kernels, as in the reference."""
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, kv_len, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, kv_len, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with O(S) residuals ``(q, k, v, o, lse, kv_len)``,
    the counterpart of the reference's ``custom_vjp``.  The backward
    recomputes the score tiles (K2, K3); ``kv_len`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len=None, causal: bool = True,
                window: int = 0):
        o, lse = flash_fwd(q, k, v, kv_len, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, kv_len)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), kv_len,
                               ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None
