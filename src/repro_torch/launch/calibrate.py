"""Measure the planning constants of ``launch/roofline.py`` on a CUDA
device.

* ``peak_flops`` — a GEMM rate at a given (m, k, n) and dtype: 2 m k n
  over the mean time of a ``torch.mm``.  ``PEAK_FLOPS`` is the fp32 rate
  with TF32 off, as the bert path runs, at the bert MLP's 3328 x 768 x
  3072 (the default); ``PEAK_FLOPS_BF16`` the bf16 rate at the hymba
  MLP's 3584 x 1600 x 5504 (``BF16_SHAPE``).
* ``pcie_bandwidth`` — one pinned host -> device and device -> host
  round trip of ``nbytes``: bytes per direction over the round trip's
  time per direction, the median of ``reps`` round trips.
* ``microbatch_overhead`` — a trainer's warm step at split k = 2 minus
  the same step at k = 1, under the same plan on the same batch: the
  difference of the medians over blocks of steps taken in turns; then
  one step at each k under ``torch.profiler`` for its device time and
  kernel launches (``device_rows``), to tell device time from host
  time.

``chip_smoke.py`` runs them all and prints them beside the card's name
and power limit.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after three
    warm calls."""
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


# (m, k, n) of PEAK_FLOPS_BF16: the hymba MLP at B = 8, S = 448
BF16_SHAPE = (3584, 1600, 5504)


def peak_flops(m: int = 3328, k: int = 768, n: int = 3072,
               reps: int = 50, dtype=torch.float32) -> float:
    """FLOP/s of a ``torch.mm`` (m, k) x (k, n) in ``dtype``, with TF32
    off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        c = torch.empty((m, n), device="cuda", dtype=dtype)
        ms = _cuda_ms(lambda: torch.mm(a, b, out=c), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * m * k * n / (ms * 1e-3)


def pcie_bandwidth(nbytes: int = 256 << 20, reps: int = 5) -> float:
    """Bytes per second per direction over one pinned round trip."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    back = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    times = []
    for i in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dev.copy_(host, non_blocking=True)
        back.copy_(dev, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        if i:                              # the first is a warm-up
            times.append(start.elapsed_time(end) * 1e-3)
    return 2.0 * nbytes / float(np.median(times))


def device_rows(prof) -> list:
    """(device ms, launches, kernel name) per kernel of a
    ``torch.profiler`` trace, longest first."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def microbatch_overhead(trainer, batch, rounds: int = 2,
                        steps: int = 3) -> dict:
    """Warm step time at k = 2 minus k = 1 under the planner's plan for
    ``batch`` (host wall time around a synchronised step).  Each k runs
    in blocks of ``steps`` timed steps after one untimed step, so every
    timed step follows a step at the same k; the blocks alternate
    k = 1, 2, 2, 1 for ``rounds`` rounds.  Then one more step at each k
    under ``torch.profiler``.  Returns the difference of the medians,
    every timed step, and per k the profiled step's device kernel ms
    and kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    tb = trainer._prepare(batch)
    actions, _ = trainer.planner.plan(tb)
    opt_state = trainer.optimizer.init(trainer.params)
    fns = {k: trainer._get_step_fn(actions, tb, k)[0] for k in (1, 2)}
    bucket = trainer.planner.bucket_key(tb)
    times = {1: [], 2: []}

    def one(k):
        nonlocal opt_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = fns[k].grads(tb)
        opt_state, _ = trainer._update(fns[k], grads, opt_state, tb, bucket,
                                       trainer._step_key(actions, tb, k), 0)
        float(loss)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(rounds):
        for k in (1, 2, 2, 1):
            one(k)
            times[k] += [one(k) for _ in range(steps)]
    profiled = {}
    for k in (1, 2):
        one(k)                             # the profiled step follows k
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one(k)
        rows = device_rows(prof)
        profiled[k] = {"device_ms": sum(r[0] for r in rows),
                       "kernels": sum(r[1] for r in rows)}
    return {"overhead_s": float(np.median(times[2]) - np.median(times[1])),
            "k1_s": times[1], "k2_s": times[2], "profiled": profiled,
            "n_remat": sum(int(a) == 1 for a in actions)}
