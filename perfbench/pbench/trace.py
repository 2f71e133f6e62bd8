"""The traced stretch: spans around the program's calls, the profiler's
device events, and what they add up to.

Spans come from the benchmark's own files.  A metric reader names the
program's ``torch.autograd.Function`` classes it needs under ``SPANS``
(``{tag: "module:Class"}``); for the traced stretch their ``forward``
and ``backward`` run inside a ``record_function`` range
``perfbench.<tag>.fwd`` / ``.bwd``, and each call's tensor arguments
(shapes, dtypes, and the values of 1-d integer ones such as ``kv_len``)
are recorded.  The profiler lays each range over the device time of the
operations launched inside it; a marker operation (one element added
to) at the range's start and end makes that interval hold every kernel
of the call, also one launched through ``ctypes`` that the profiler
cannot tie to the range, and the markers themselves are left out.  So
time is attributed by the call, not by the kernel's name.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

STRETCH = "perfbench.stretch"
STEP = "perfbench.step"
# the kernel of ``torch.cuda._sleep``, launched at the start and the end
# of the device-only stretch: its window on the device's clock
EDGE_KERNEL = "spin_kernel"


def mark_edge(device) -> None:
    """The stretch's edge on the device: every queued operation done,
    then one short kernel of a name nothing else launches, waited for
    (the end edge is the last kernel before the profiler stops)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Call:
    tag: str
    phase: str                    # "fwd" or "bwd"
    args: list                    # [(shape, dtype, values or None)]


class SpanPatch:
    """Wraps the named Functions' forward and backward while active."""

    def __init__(self, spans: Dict[str, str]):
        self.spans = dict(spans)
        self.calls: List[Call] = []
        self._saved: list = []
        self._marks: Dict[torch.device, torch.Tensor] = {}

    def _mark(self, device) -> None:
        """One tiny device operation, the first or last of a range."""
        if device is not None and device.type == "cuda":
            if device not in self._marks:
                self._marks[device] = torch.zeros(1, device=device)
            self._marks[device].add_(1.0)

    @staticmethod
    def _summary(args) -> list:
        out = []
        for a in args:
            if isinstance(a, torch.Tensor):
                vals = (a.detach().clone() if a.dim() == 1
                        and not a.is_floating_point() else None)
                out.append([tuple(a.shape), str(a.dtype), vals])
        return out

    def __enter__(self):
        for tag, target in self.spans.items():
            mod, name = target.split(":")
            cls = getattr(importlib.import_module(mod), name)
            fwd0, bwd0 = cls.forward, cls.backward
            self._saved.append((cls, fwd0, bwd0))

            def fwd(ctx, *args, _f=fwd0, _tag=tag, **kw):
                summary = self._summary(args)
                dev = next((a.device for a in args
                            if isinstance(a, torch.Tensor)), None)
                ctx._perfbench_args, ctx._perfbench_dev = summary, dev
                self.calls.append(Call(_tag, "fwd", summary))
                with record_function(f"perfbench.{_tag}.fwd"):
                    self._mark(dev)
                    out = _f(ctx, *args, **kw)
                    self._mark(dev)
                return out

            def bwd(ctx, *grads, _b=bwd0, _tag=tag):
                dev = getattr(ctx, "_perfbench_dev", None)
                self.calls.append(Call(_tag, "bwd",
                                       getattr(ctx, "_perfbench_args", [])))
                with record_function(f"perfbench.{_tag}.bwd"):
                    self._mark(dev)
                    out = _b(ctx, *grads)
                    self._mark(dev)
                return out
            cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
        return self

    def __exit__(self, *exc):
        for cls, fwd0, bwd0 in reversed(self._saved):
            cls.forward, cls.backward = staticmethod(fwd0), staticmethod(bwd0)
        self._saved = []
        # the recorded integer arguments, read once the stretch is over
        for call in self.calls:
            for a in call.args:
                if isinstance(a[2], torch.Tensor):
                    a[2] = [int(x) for x in a[2].cpu().tolist()]
        return False


@dataclasses.dataclass
class TraceData:
    """Two stretches of the same length: one traced on the device only
    (busy time and the longest operations, without the host-side
    profiling that slows a step), one with the host's events and the
    spans (device time by call, idle gaps by what the host did)."""
    window_s: float                       # the device-only stretch's length
    busy_s: float                         # union of its device events
    tagged_s: Dict[str, float]            # device time by span tag
    calls: List[Call]
    device_ops: List[Tuple[str, float]]   # the longest, by name
    idle_gaps: List[Tuple[str, float]]    # by what the host was doing
    n_device_events: int


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(events: List[Tuple[int, int, str]], points: List[int]
               ) -> List[Optional[str]]:
    """For each point (sorted), the name of the innermost event of one
    thread's properly nested ``events`` (sorted by start) covering it."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _events(prof) -> tuple:
    """(device operations as (start ns, end ns, name), the device copies
    of the tag ranges as (start, end, tag), host events as (thread,
    start, end, name)) of one trace, in one pass over its events."""
    cuda = torch.autograd.DeviceType.CUDA
    device, annotations, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith("perfbench."):
                # the profiler lays each host range over the device
                # time of the kernels launched inside it
                if name.count(".") == 2:
                    annotations.append((s, end, name.split(".")[1]))
            else:
                device.append((s, end, name))
        else:
            host.append((e.start_thread_id(), s, end, name))
    device.sort()
    return device, annotations, host


def busy(prof, host_s: float, top: int = 10) -> tuple:
    """(window seconds, its clock, busy seconds, the longest device
    operations by name, how many) of a device-only trace between two
    ``mark_edge`` calls.  The window is on the trace's clock, from the
    start of the first edge kernel to the end of the second; where the
    trace does not hold exactly those two (no device; a later profiling
    session of one process can miss one), it is the host's ``host_s``.
    Busy is the union of the other device events, not cut to the
    window, so an event outside it shows as busy beyond the window."""
    device, _, _ = _events(prof)
    edges = [(s, e) for s, e, name in device if EDGE_KERNEL in name]
    device = [d for d in device if EDGE_KERNEL not in d[2]]
    if len(edges) == 2:
        window_s, clock = (edges[1][1] - edges[0][0]) / 1e9, "trace"
    else:
        # where the traced edges lie against the other device events
        # (before the first: negative)
        t0 = min(s for s, _, _ in device) if device else 0
        t1 = max(e for _, e, _ in device) if device else 0
        at = "".join(f", one at {(s - t0) / 1e9:.4f} s" for s, _ in edges)
        window_s, clock = host_s, (f"host ({len(edges)} edge kernels "
                                   f"traced{at} of {(t1 - t0) / 1e9:.4f} s"
                                   f" of device events)")
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    union = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in union) / 1e9
    return window_s, clock, busy_s, _rank(by_name, top), len(device)


def _rank(d: Dict[str, float], top: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def spans(prof, top: int = 10) -> tuple:
    """({tag: device seconds of the operations inside its ranges' device
    intervals}, {tag: its longest operations}, the idle gaps of the
    stretch by the host operation running on the main thread) of a
    trace with host events.  One stream
    runs the step in order, so every device operation inside a range's
    device interval was launched by that call."""
    device, annotations, host = _events(prof)
    stretch = next(((s, e, tid) for tid, s, e, name in host
                    if name == STRETCH), None)
    if stretch is None:
        raise RuntimeError("the trace has no perfbench.stretch range")
    t0, t1, main_tid = stretch
    device = [d for d in device if d[1] > t0 and d[0] < t1]
    starts = [d[0] for d in device]
    tagged: Dict[str, float] = {}
    names: Dict[str, Dict[str, float]] = {}
    for a0, a1, tag in annotations:
        i = bisect.bisect_left(starts, a0)
        inside = []
        while i < len(device) and device[i][0] <= a1:
            if device[i][1] <= a1:
                inside.append(device[i])
            i += 1
        # the first and the last are the range's markers
        for s, e, name in inside[1:-1]:
            tagged[tag] = tagged.get(tag, 0.0) + (e - s) / 1e9
            by = names.setdefault(tag, {})
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
    gaps, prev = [], t0
    for s, e in _union([(max(s, t0), min(e, t1)) for s, e, _ in device]):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    main = sorted((s, e, name) for tid, s, e, name in host if tid == main_tid)
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    idle: Dict[str, float] = {}
    for (_, dur), name in zip(mids, _innermost(main, [m for m, _ in mids])):
        key = name or "host: no operation"
        idle[key] = idle.get(key, 0.0) + dur / 1e9
    return tagged, {t: _rank(d, 3) for t, d in names.items()}, _rank(idle, top)
