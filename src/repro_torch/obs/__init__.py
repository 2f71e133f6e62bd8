"""Unified observability layer: metrics, events and span traces — a
copy of the reference's ``obs`` package (pure Python; it imports
neither jax nor numpy there either).

One :class:`Telemetry` object bundles the three surfaces and is
threaded through the trainer, the planner, the background solver and
the transfer lane:

* ``telemetry.metrics`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  that is **always live**: component ``stats`` mappings are
  :class:`~repro_torch.obs.metrics.StatsView` facades over it, so counting
  costs the same whether telemetry is "on" or "off" and a snapshot is
  always available for reports (`to_prometheus()` / `to_json()`).
* ``telemetry.events`` — a structured JSONL
  :class:`~repro_torch.obs.events.EventLog` (or a no-op
  :class:`~repro_torch.obs.events.NullEventLog`).  Guard emission at call
  sites with ``telemetry.events_on`` so the disabled path never builds
  kwargs.
* ``telemetry.tracer`` — a Perfetto
  :class:`~repro_torch.obs.tracing.SpanTracer` (or
  :class:`~repro_torch.obs.tracing.NullTracer` whose ``span()`` returns a
  shared singleton — zero allocation when disabled).

``Telemetry.disabled()`` is the default everywhere: metrics only, no
events, no spans, no sinks — and is behavior-identical to the
pre-telemetry code (the bert losses are bitwise equal with every sink
on and off; ``chip_smoke.py`` checks it on the card).
"""
from __future__ import annotations

from typing import Optional

from .events import SCHEMA_VERSION, EventLog, NullEventLog, read_events
from .metrics import (Counter, Gauge, Histogram, LabelView,
                      MetricsRegistry, StatsView)
from .tracing import (NULL_SPAN, NullTracer, SpanTracer, TRACK_PLANNER,
                      TRACK_SERVE, TRACK_SOLVER, TRACK_STEP,
                      TRACK_TRANSFER)

__all__ = [
    "Telemetry", "build_telemetry",
    "MetricsRegistry", "StatsView", "LabelView",
    "Counter", "Gauge", "Histogram",
    "EventLog", "NullEventLog", "read_events", "SCHEMA_VERSION",
    "SpanTracer", "NullTracer", "NULL_SPAN",
    "TRACK_STEP", "TRACK_PLANNER", "TRACK_TRANSFER", "TRACK_SERVE",
    "TRACK_SOLVER",
]


class Telemetry:
    """Bundle of (metrics registry, event log, span tracer)."""

    __slots__ = ("metrics", "events", "tracer", "events_on", "trace_on",
                 "_paths")

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 events=None, tracer=None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events = events if events is not None else NullEventLog()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.events_on = bool(getattr(self.events, "enabled", False))
        self.trace_on = bool(getattr(self.tracer, "enabled", False))

    @classmethod
    def disabled(cls) -> "Telemetry":
        """Metrics-only telemetry: no events, no spans, no sinks."""
        return cls()

    @classmethod
    def enabled(cls, events_path: Optional[str] = None,
                ring_capacity: int = 4096,
                trace_capacity: int = 200_000) -> "Telemetry":
        return cls(events=EventLog(capacity=ring_capacity,
                                   path=events_path),
                   tracer=SpanTracer(capacity=trace_capacity))

    def close(self) -> None:
        self.events.close()


def build_telemetry(metrics_path: Optional[str] = None,
                    events_path: Optional[str] = None,
                    trace_path: Optional[str] = None) -> Telemetry:
    """Construct Telemetry from the launcher's flags.

    Any non-None path turns its surface on; ``flush_telemetry`` writes
    the artifacts at exit.  All three None → fully disabled."""
    events = EventLog(path=events_path) if events_path else None
    tracer = SpanTracer() if trace_path else None
    tel = Telemetry(events=events, tracer=tracer)
    tel._paths = {"metrics": metrics_path, "events": events_path,  # type: ignore[attr-defined]
                  "trace": trace_path}
    return tel


def flush_telemetry(tel: Telemetry) -> dict:
    """Write the artifacts the launcher asked for (the metrics file by
    extension: ``.json`` → JSON snapshot, anything else → Prometheus
    text), flush the event sink and save the trace.  Returns
    ``{kind: path}`` for every artifact actually written."""
    paths = getattr(tel, "_paths", {})
    written = {}
    mp = paths.get("metrics")
    if mp:
        with open(mp, "w") as f:
            if mp.endswith(".json"):
                f.write(tel.metrics.to_json(indent=2))
            else:
                f.write(tel.metrics.to_prometheus())
        written["metrics"] = mp
    tp = paths.get("trace")
    if tp:
        tel.tracer.save(tp)
        written["trace"] = tp
    ep = paths.get("events")
    if ep:
        written["events"] = ep
    tel.events.close()
    return written
