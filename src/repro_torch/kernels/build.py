"""Build and load the port's CUDA kernels; what every kernel wrapper
shares.

Each source ``csrc/<name>.cu`` has a plain C interface (every pointer
and the stream as ``void*``, the launch's ``cudaError_t`` returned).  It
is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the repository root, keyed by a hash of the
source, the headers beside it (``csrc/*.cuh``) and the flags, and loaded
with ``ctypes``.  ``build`` starts one ``nvcc`` per source that is not
built yet, all at once, and waits for them.

``LAUNCHES`` counts each kernel's launches; a wrapper adds one right
after its kernel launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_fma": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dq_fma": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_dkv_fma": 0,
                            "ssd_scan": 0, "ssd_scan_fma": 0, "dma_copy": 0,
                            "adamw": 0, "adamw_norm": 0}


def nvcc() -> str:
    path = shutil.which("nvcc")
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if path is None and default.exists():
        path = str(default)
    if path is None:
        raise RuntimeError(
            f"nvcc not found: the kernels are compiled from {CSRC} at first "
            f"use and need the CUDA toolkit")
    return path


def library_path(src: Path) -> Path:
    """The library built from ``src``, keyed by its bytes, the headers
    beside it (``*.cuh``, which a source may include) and the flags."""
    parts = [src.read_bytes()]
    parts += [h.read_bytes() for h in sorted(src.parent.glob("*.cuh"))]
    tag = hashlib.sha256(b"".join(parts)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{tag}.so"


def build(*sources: Path) -> List[Path]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; returns the libraries' paths.  Raises if ``nvcc`` is
    missing or any compile fails."""
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, tmp, out, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(src: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build ``src`` if needed and load it; ``signatures`` maps each C
    function to its ``argtypes`` (every function returns an int)."""
    lib = ctypes.CDLL(str(build(src)[0]))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def route(t: torch.Tensor, what: str) -> str:
    """'kernel' for CUDA tensors, 'plain' for CPU, 'meta' for meta."""
    if t.is_cuda:
        return "kernel"
    if t.device.type in ("cpu", "meta"):
        return "plain" if t.device.type == "cpu" else "meta"
    raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                     f"version), not {t.device}")


def route_all(tensors, what: str) -> str:
    """How an operation over several tensors runs: 'plain' where none is
    on CUDA (a DTensor is where its local shard is); 'kernel' where all
    are plain tensors on one CUDA device; 'shards' where all are
    DTensors whose shards are on one CUDA device (the kernels run on the
    shards).  A mix of CUDA and other devices, or of DTensors and plain
    tensors on CUDA, raises."""
    tensors = list(tensors)
    devices = {t.device for t in tensors}
    if not any(d.type == "cuda" for d in devices):
        return "plain"
    if len(devices) > 1:
        raise ValueError(f"{what} runs on one CUDA device, not on "
                         f"{sorted(map(str, devices))}")
    n_dt = 0
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor
        n_dt = sum(isinstance(t, DTensor) for t in tensors)
    if 0 < n_dt < len(tensors):
        raise ValueError(f"{what} takes DTensors or plain tensors, not "
                         f"a mix")
    return "shards" if n_dt else "kernel"


def check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
