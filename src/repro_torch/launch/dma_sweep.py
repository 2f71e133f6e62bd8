"""Time builds of the DMA copy kernel against each other and against
``Tensor.copy_`` on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.dma_sweep \\
        [--ring STAGES,TILE,CTAS_PER_SM,LAG ...] [--source FILE.cu ...]

Each variant is ``csrc/offload_dma.cu`` with its ring constants set by a
``--ring`` (none given: the committed ring), or another source with the
same C entry point ``dma_copy`` (``--source``, for example an earlier
commit's).  All are compiled at once into ``build/dma_sweep/``, checked
for identical bytes on odd byte counts and offsets, and timed with CUDA
events at the mamba2 logits shape (8, 416, 50280) fp32 with chunks of
``--chunk-elems``.  Variants and ``copy_`` take turns: each round times
every variant (in reverse order on odd rounds), each followed by
``copy_``; a variant's ratio is its mean over its ``copy_`` turns' mean.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build

RING = ("STAGES", "TILE", "CTAS_PER_SM", "LAG")
OUT = build.BUILD_DIR.parent / "dma_sweep"
# (bytes, src offset, dst offset, chunk bytes) off 16-byte alignment
ODD_CASES = ((100_003, 5, 5, 4096), (100_003, 0, 3, 4096),
             (1_000_001, 13, 13, 65536), (33, 0, 0, 7))


def with_ring(text: str, ring) -> str:
    for name, value in zip(RING, ring):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{name} is not a constant of the source")
    return text


def compile_all(texts):
    """One ``nvcc`` per source text, all at once; returns the entry points."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, text in enumerate(texts):
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        procs.append(subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"v{i}.so"),
             str(src)]))
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on a variant")
    fns = []
    for i in range(len(texts)):
        fn = ctypes.CDLL(str(OUT / f"v{i}.so")).dma_copy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
            ctypes.c_void_p]
        fns.append(fn)
    return fns


def identical_on_odd_cases(fn, stream) -> bool:
    for n, so, do, chunk in ODD_CASES:
        src = torch.randint(0, 256, (n + 32,), device="cuda",
                            dtype=torch.int32).to(torch.uint8)
        dst = torch.zeros_like(src)
        build.raise_on(fn(src.data_ptr() + so, dst.data_ptr() + do, n, chunk,
                          stream), "dma_copy")
        torch.cuda.synchronize()
        if not (torch.equal(dst[do:do + n], src[so:so + n])
                and not bool(dst[:do].any()) and not bool(dst[do + n:].any())):
            return False
    return True


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ring", action="append", default=[],
                    help="STAGES,TILE,CTAS_PER_SM,LAG for csrc/offload_dma.cu")
    ap.add_argument("--source", action="append", default=[], type=Path,
                    help="another source with the same dma_copy entry point")
    ap.add_argument("--chunk-elems", type=int, default=1 << 15)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sweep times kernels on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    base = (build.CSRC / "offload_dma.cu").read_text()
    names = ([f"ring {r}" for r in args.ring] + [str(s) for s in args.source]
             or ["committed"])
    texts = ([with_ring(base, r.split(",")) for r in args.ring]
             + [s.read_text() for s in args.source] or [base])
    fns = compile_all(texts)
    stream = torch.cuda.current_stream().cuda_stream
    src = torch.randn(8, 416, 50280, device="cuda")
    dst = torch.empty_like(src)
    nbytes, chunk = src.numel() * 4, args.chunk_elems * 4
    for name, fn in zip(names, fns):
        dst.zero_()
        build.raise_on(fn(src.data_ptr(), dst.data_ptr(), nbytes, chunk,
                          stream), "dma_copy")
        torch.cuda.synchronize()
        if not (torch.equal(dst, src) and identical_on_odd_cases(fn, stream)):
            raise AssertionError(f"{name}: the copy differs")
    kernel_ms = {n: [] for n in names}
    copy_ms = {n: [] for n in names}
    for r in range(args.rounds):
        order = list(zip(names, fns))
        for name, fn in order[::-1] if r % 2 else order:
            kernel_ms[name].append(time_ms(lambda: fn(
                src.data_ptr(), dst.data_ptr(), nbytes, chunk, stream)))
            copy_ms[name].append(time_ms(lambda: dst.copy_(src)))
    bound = 2 * nbytes / 3.35e12 * 1e3
    for name in names:
        k, c = kernel_ms[name], copy_ms[name]
        print(f"{name}: kernel {' '.join(f'{t:.4f}' for t in k)} ms, copy_ "
              f"{' '.join(f'{t:.4f}' for t in c)} ms, ratio "
              f"{sum(k) / sum(c):.4f}, bound {bound:.4f} ms (chunk "
              f"{chunk} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
