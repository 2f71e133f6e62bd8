"""Span tracer emitting Chrome ``trace_event`` JSON for Perfetto (a copy
of the reference's ``obs/tracing.py``).

Spans are complete events (``"ph": "X"``) with microsecond timestamps,
grouped into named tracks (Chrome "threads"): the train step loop,
the planner, the transfer lane and the serve scheduler each get their
own row in the Perfetto UI, so the transfer lane's measured
``exposed`` spans sit visually under the ``execute`` span they steal
time from.

The disabled path is a strict no-op: :class:`NullTracer.span` returns
one shared :data:`NULL_SPAN` singleton (no allocation per call) whose
``__enter__``/``__exit__`` do nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

__all__ = ["SpanTracer", "NullTracer", "NULL_SPAN",
           "TRACK_STEP", "TRACK_PLANNER", "TRACK_TRANSFER", "TRACK_SERVE",
           "TRACK_SOLVER"]

# stable Chrome "thread ids" = Perfetto tracks
TRACK_STEP = 1
TRACK_PLANNER = 2
TRACK_TRANSFER = 3
TRACK_SERVE = 4
TRACK_SOLVER = 5

_TRACK_NAMES = {
    TRACK_STEP: "train.step",
    TRACK_PLANNER: "planner",
    TRACK_TRANSFER: "transfer",
    TRACK_SERVE: "serve",
    TRACK_SOLVER: "solver",
}


class _Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tracer", "name", "track", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, track: int,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self.name, self._t0,
                              time.perf_counter() - self._t0,
                              track=self.track, args=self.args)
        return False


class _NullSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanTracer:
    """Collects Chrome ``trace_event`` complete events in memory.

    ``span()`` measures with ``time.perf_counter``; ``complete()``
    accepts explicit (start, duration) pairs so retroactive spans
    (serve queue-wait, virtual-clock engines) land on the same tracks.
    Appends to the event list are GIL-atomic, so the transfer-lane
    worker thread and the train thread can trace concurrently.
    """

    enabled = True

    def __init__(self, capacity: int = 200_000):
        self._events: List[dict] = []
        self._capacity = int(capacity)
        self._pid = os.getpid()
        self._meta_emitted = set()
        self._lock = threading.Lock()

    def span(self, name: str, track: int = TRACK_STEP,
             args: Optional[dict] = None) -> _Span:
        return _Span(self, name, track, args)

    def complete(self, name: str, start_s: float, dur_s: float,
                 track: int = TRACK_STEP,
                 args: Optional[dict] = None) -> None:
        if len(self._events) >= self._capacity:
            return
        self._ensure_track(track)
        ev = {"ph": "X", "name": name, "pid": self._pid, "tid": track,
              "ts": start_s * 1e6, "dur": max(dur_s, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, track: int = TRACK_STEP,
                args: Optional[dict] = None,
                ts_s: Optional[float] = None) -> None:
        """Zero-duration marker (plan swaps, OOM events, refits)."""
        if len(self._events) >= self._capacity:
            return
        self._ensure_track(track)
        ev = {"ph": "i", "s": "t", "name": name, "pid": self._pid,
              "tid": track,
              "ts": (time.perf_counter() if ts_s is None else ts_s) * 1e6}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def _ensure_track(self, track: int) -> None:
        if track in self._meta_emitted:
            return
        with self._lock:
            if track in self._meta_emitted:
                return
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": self._pid,
                "tid": track,
                "args": {"name": _TRACK_NAMES.get(track, f"track{track}")},
            })
            self._meta_emitted.add(track)

    def events(self) -> List[dict]:
        return list(self._events)

    def to_json(self) -> str:
        return json.dumps({"traceEvents": self.events(),
                           "displayTimeUnit": "ms"})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def __len__(self):
        return len(self._events)


class NullTracer:
    """Disabled tracer: every span is the shared :data:`NULL_SPAN`."""

    enabled = False

    def span(self, name: str, track: int = TRACK_STEP,
             args: Optional[dict] = None) -> _NullSpan:
        return NULL_SPAN

    def complete(self, name, start_s, dur_s, track=TRACK_STEP,
                 args=None) -> None:
        return None

    def instant(self, name, track=TRACK_STEP, args=None,
                ts_s=None) -> None:
        return None

    def events(self) -> List[dict]:
        return []

    def to_json(self) -> str:
        return json.dumps({"traceEvents": []})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def __len__(self):
        return 0
