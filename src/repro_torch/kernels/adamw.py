"""AdamW's update and clip norm: hand-written CUDA kernels for Hopper.

======================  ======================================  =================
entry point             CUDA kernels                            TPU kernel
======================  ======================================  =================
``update``              ``adamw_kernel<bf16 | fp32>``           none (XLA fuses)
``clip_scale``          ``adamw_norm_partial_kernel``,          none
                        ``adamw_norm_finish_kernel``
``clip_scale_sharded``  the same two, then the finish kernel    none
                        over the sum added over the mesh
======================  ======================================  =================

The plain version is ``optim/adamw.py``'s formula, which ``AdamW`` runs
for CPU tensors (and DTensors whose shards are on the CPU); these are
its kernel path for CUDA tensors and for DTensors whose shards are on a
card (``build.route_all``: the kernels then run on the shards,
``local_shards``), bound by bytes (``csrc/adamw.cu``).

``update`` writes one parameter and its fp32 moments in place, the
same arithmetic in the same order (on the card, given the same clip
scale, the plain version's bits), and allocates nothing.  It takes a
(param, grad) pair of (bf16, bf16) or (fp32, fp32) with fp32 m and v,
all contiguous, of one shape, on one device, and raises on anything
else.  ``clip_scale`` returns ``min(1, clip / (norm + 1e-9))`` over
every gradient (bf16 or fp32, contiguous) as a 0-d fp32 device tensor:
no host synchronisation, two kernel launches whatever the number of
gradients, and the same bits on every run (no atomics).
``clip_scale_sharded`` takes DTensor gradients: each rank sums the
squares of the shards it counts, the sums are added over the mesh, and
the scale is taken from the total; on a one-device mesh it has
``clip_scale``'s bits over the full tensors.

``LAUNCHES["adamw"]`` counts one per parameter updated and
``LAUNCHES["adamw_norm"]`` one per clip scale (its two kernels; three on
the shard route).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

_SRC = build.CSRC / "adamw.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# elements per chunk of the norm, and the most CTAs its first launch
# takes (the partial sums' room)
NORM_CHUNK, NORM_MAX_CTAS = 1 << 18, 1024

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        _lib = build.load(_SRC, {
            "adamw": [p, p, p, p, ll, i, p] + [f] * 9 + [p],
            "adamw_norm": [p, i, ll, ll, p, i, f, p, p],
            "adamw_norm_sum": [p, i, ll, ll, p, i, p, p],
            "adamw_norm_scale": [p, f, p, p]})
    return _lib


def _stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _alloc(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _table(rows, device) -> torch.Tensor:
    """The norm's table on ``device``: copied from pinned memory without
    a host synchronisation."""
    host = torch.tensor(rows, dtype=torch.int64, pin_memory=True)
    return host.to(device, non_blocking=True)


def _dtype_code(t: torch.Tensor, name: str) -> int:
    code = _DTYPE_CODE.get(t.dtype)
    if code is None:
        raise ValueError(f"{name} has dtype {t.dtype}; the AdamW kernel "
                         f"takes bfloat16 or float32")
    return code


def update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor, scale: Optional[torch.Tensor], *, lr: float,
           b1: float, b2: float, eps: float, weight_decay: float,
           bc1: float, bc2: float) -> None:
    """One AdamW step of ``p`` in place (and of its moments ``m``, ``v``)
    from its gradient ``g``, scaled by the device scalar ``scale`` (None:
    1)."""
    code = _dtype_code(p, "the parameter")
    build.check("the gradient", g, p.shape, p.dtype, p.device)
    build.check("the parameter", p, p.shape, p.dtype, p.device)
    for name, t in (("m", m), ("v", v)):
        build.check(name, t, p.shape, torch.float32, p.device)
    if scale is not None:
        build.check("the clip scale", scale, (), torch.float32, p.device)
    n = p.numel()
    if n == 0:
        return
    err = library().adamw(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, code,
        None if scale is None else scale.data_ptr(), b1, 1 - b1, b2, 1 - b2,
        1 / bc1, 1 / bc2, eps, weight_decay, lr, _stream_handle(p.device))
    build.raise_on(err, "adamw")
    LAUNCHES["adamw"] += 1


def _norm_table(grads: Sequence[torch.Tensor], device):
    """The norm's table of ``grads`` on ``device``, its rows and chunks."""
    rows, n_chunks = [], 0
    for i, g in enumerate(grads):
        code = _dtype_code(g, f"gradient {i}")
        build.check(f"gradient {i}", g, g.shape, g.dtype, device)
        if g.numel():
            rows.append([g.data_ptr(), g.numel(), n_chunks, code])
            n_chunks += -(-g.numel() // NORM_CHUNK)
    return _table(rows or [[0, 0, 0, 0]], device), len(rows), n_chunks


def clip_scale(grads: Sequence[torch.Tensor], clip_norm: float
               ) -> torch.Tensor:
    """``min(1, clip_norm / (||grads|| + 1e-9))`` as a 0-d fp32 tensor on
    the gradients' device, the norm over every element of every one."""
    device = grads[0].device
    table, n_rows, n_chunks = _norm_table(grads, device)
    partial = _alloc((NORM_MAX_CTAS,), torch.float64, device)
    scale = _alloc((), torch.float32, device)
    err = library().adamw_norm(table.data_ptr(), n_rows, n_chunks,
                               NORM_CHUNK, partial.data_ptr(), NORM_MAX_CTAS,
                               clip_norm, scale.data_ptr(),
                               _stream_handle(device))
    build.raise_on(err, "adamw_norm")
    LAUNCHES["adamw_norm"] += 1
    return scale


def local_shards(tensors: Sequence, what: str) -> list:
    """The local shards of DTensors on one mesh at one set of placements,
    which line up element for element; raises where they do not."""
    first = tensors[0]
    for t in tensors[1:]:
        if (t.device_mesh != first.device_mesh
                or tuple(t.placements) != tuple(first.placements)):
            raise ValueError(f"{what}: the shards do not line up "
                             f"({first.placements} and {t.placements})")
    return [t.to_local() for t in tensors]


def clip_scale_sharded(grads: Sequence, clip_norm: float) -> torch.Tensor:
    """``clip_scale`` over DTensor gradients on one mesh whose shards are
    on this rank's card, as a plain 0-d fp32 tensor there.  Each element
    counts once over the mesh: a rank sums the shards that it holds at
    coordinate 0 of every mesh dimension they are replicated over, and the
    sums are added over every dimension of more than one rank."""
    import torch.distributed as dist
    mesh = grads[0].device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank holds no part of the gradients' mesh")
    mine = []
    for i, g in enumerate(grads):
        if g.device_mesh != mesh:
            raise ValueError(f"gradient {i} is on another mesh")
        if any(pl.is_partial() for pl in g.placements):
            raise ValueError(f"gradient {i} is partial ({g.placements})")
        if all(c == 0 for c, pl in zip(coord, g.placements)
               if pl.is_replicate()):
            mine.append(g.to_local())
    device = grads[0].to_local().device
    table, n_rows, n_chunks = _norm_table(mine, device)
    partial = _alloc((NORM_MAX_CTAS,), torch.float64, device)
    total = _alloc((), torch.float64, device)
    stream = _stream_handle(device)
    err = library().adamw_norm_sum(table.data_ptr(), n_rows, n_chunks,
                                   NORM_CHUNK, partial.data_ptr(),
                                   NORM_MAX_CTAS, total.data_ptr(), stream)
    build.raise_on(err, "adamw_norm")
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.all_reduce(total, group=mesh.get_group(d))
    scale = _alloc((), torch.float32, device)
    err = library().adamw_norm_scale(total.data_ptr(), clip_norm,
                                     scale.data_ptr(), stream)
    build.raise_on(err, "adamw_norm")
    LAUNCHES["adamw_norm"] += 1
    return scale
