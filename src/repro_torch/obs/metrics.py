"""Metrics registry: counters, gauges and histograms with labels (a
copy of the reference's ``obs/metrics.py``).

The registry is the single store for every runtime counter in the
system — trainer JIT-cache stats, planner decision counters, watchdog
OOM tallies, transfer-lane byte counts and serve-engine admission
outcomes all live here instead of in per-component ad-hoc dicts.

Design constraints:

* **Lock-free hot path.**  ``Counter.inc`` never takes a lock: each
  (labelset, thread) pair owns a private accumulator cell, so
  concurrent writers (the background solver daemon and the training
  thread) can bump the same metric without losing increments — dict
  item stores are atomic under the GIL and every cell has exactly one
  writer.  Locks are only taken when *creating* a metric (registry
  mutation) and when *snapshotting* (read side).
* **Dict-shaped compatibility.**  :class:`StatsView` exposes a set of
  registry metrics through the ``MutableMapping`` protocol so existing
  call sites (``planner.stats["cache_hits"] += 1``, ``dict(wd.stats)``)
  keep working unchanged while the storage is shared and exportable.
* **Export.**  ``snapshot()`` returns plain data; ``to_prometheus()``
  renders the text exposition format; ``to_json()`` a stable JSON doc.
"""
from __future__ import annotations

import bisect
import json
import threading
from collections.abc import Mapping, MutableMapping
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsView",
    "LabelView",
]

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared plumbing: name/help/kind plus per-(labelset, thread) cells."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        # labelset -> {thread_id -> cell}; each cell is written by
        # exactly one thread, so no lock is needed on the write path.
        self._cells: Dict[_LabelKey, dict] = {}

    def _per_thread(self, labels: dict) -> dict:
        key = _label_key(labels)
        per = self._cells.get(key)
        if per is None:
            # setdefault is atomic under the GIL: two racing threads
            # converge on one shared dict for this labelset.
            per = self._cells.setdefault(key, {})
        return per

    def labelsets(self) -> Iterable[_LabelKey]:
        return list(self._cells.keys())

    # -- merge support (single-threaded, used when re-binding a
    #    component's metrics into a shared registry) ------------------
    def _merge_from(self, other: "_Metric") -> None:
        for key, per in other._cells.items():
            dst = self._cells.setdefault(key, {})
            for tid, cell in per.items():
                if tid in dst:
                    dst[(tid, id(other))] = cell
                else:
                    dst[tid] = cell


class Counter(_Metric):
    """Monotonic (but resettable) float counter with optional labels."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        per = self._per_thread(labels)
        tid = threading.get_ident()
        per[tid] = per.get(tid, 0.0) + n

    def set(self, v: float, **labels) -> None:
        """Absolute set (single-writer contexts, e.g. mirroring an LRU
        eviction count).  Collapses all cells for the labelset."""
        key = _label_key(labels)
        self._cells[key] = {threading.get_ident(): float(v)}

    def value(self, **labels) -> float:
        per = self._cells.get(_label_key(labels))
        return float(sum(per.values())) if per else 0.0

    def total(self) -> float:
        return float(sum(sum(per.values()) for per in self._cells.values()))

    def items(self) -> Dict[_LabelKey, float]:
        return {k: float(sum(per.values())) for k, per in self._cells.items()}


class Gauge(_Metric):
    """Last-written value per labelset (plus ``set_max`` for peaks)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        self._cells[_label_key(labels)] = {0: float(v)}

    def set_max(self, v: float, **labels) -> None:
        cur = self.value(**labels)
        if v > cur:
            self.set(v, **labels)

    def value(self, **labels) -> float:
        per = self._cells.get(_label_key(labels))
        return float(sum(per.values())) if per else 0.0

    total = value

    def items(self) -> Dict[_LabelKey, float]:
        return {k: float(sum(per.values())) for k, per in self._cells.items()}

    def _merge_from(self, other: "_Metric") -> None:
        # gauges are last-writer-wins, not additive
        for key, per in other._cells.items():
            if key not in self._cells:
                self._cells[key] = per


DEFAULT_BOUNDS = (1e-5, 1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                  5.0, 10.0, 60.0)


class Histogram(_Metric):
    """Fixed-bound histogram; observe() is lock-free like Counter.inc."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        super().__init__(name, help)
        self.bounds = tuple(bounds)

    def observe(self, v: float, **labels) -> None:
        per = self._per_thread(labels)
        tid = threading.get_ident()
        cell = per.get(tid)
        if cell is None:
            cell = per[tid] = [[0] * (len(self.bounds) + 1), 0.0, 0]
        i = bisect.bisect_left(self.bounds, v)
        cell[0][i] += 1
        cell[1] += v
        cell[2] += 1

    def _agg(self, per: dict):
        counts = [0] * (len(self.bounds) + 1)
        total, n = 0.0, 0
        for cell in per.values():
            for i, c in enumerate(cell[0]):
                counts[i] += c
            total += cell[1]
            n += cell[2]
        return counts, total, n

    def value(self, **labels):
        per = self._cells.get(_label_key(labels))
        if not per:
            return {"counts": [0] * (len(self.bounds) + 1),
                    "sum": 0.0, "count": 0}
        counts, total, n = self._agg(per)
        return {"counts": counts, "sum": total, "count": n}

    def items(self):
        return {k: self.value(**dict(k)) for k in self._cells.keys()}

    def total(self) -> float:
        return float(sum(self._agg(per)[2] for per in self._cells.values()))


class MetricsRegistry:
    """Name-indexed directory of metric objects with export helpers."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Tuple[float, ...] = DEFAULT_BOUNDS) -> Histogram:
        return self._get_or_create(Histogram, name, help, bounds=bounds)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def adopt(self, metric: _Metric) -> _Metric:
        """Register ``metric`` under its name; if a metric with that
        name already exists, merge values into the existing object and
        return it.  This is how two components that count the same
        thing (e.g. planner and watchdog ``oom_events``) converge on
        one shared counter when bound to one registry."""
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is None:
                self._metrics[metric.name] = metric
                return metric
            if cur is metric:
                return cur
            cur._merge_from(metric)
            return cur

    # ----------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Plain-data view: name -> {kind, help, total, values:[...]}."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            values = [{"labels": dict(k), "value": v}
                      for k, v in sorted(m.items().items())]
            entry = {"kind": m.kind, "help": m.help, "values": values}
            if m.kind != "histogram":
                entry["total"] = m.total()
            out[name] = entry
        return out

    def to_json(self, indent: int = 0) -> str:
        return json.dumps(self.snapshot(), indent=indent or None,
                          sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "histogram":
                for key in sorted(m.labelsets()):
                    val = m.value(**dict(key))
                    cum = 0
                    base = dict(key)
                    for bound, c in zip(m.bounds, val["counts"]):
                        cum += c
                        lbl = _fmt_labels({**base, "le": repr(bound)})
                        lines.append(f"{name}_bucket{lbl} {cum}")
                    cum += val["counts"][-1]
                    lbl = _fmt_labels({**base, "le": "+Inf"})
                    lines.append(f"{name}_bucket{lbl} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(base)} {val['sum']:.9g}")
                    lines.append(
                        f"{name}_count{_fmt_labels(base)} {val['count']}")
                if not m.labelsets():
                    lines.append(f"{name}_sum 0")
                    lines.append(f"{name}_count 0")
                continue
            items = m.items()
            if not items:
                lines.append(f"{name} 0")
                continue
            for key, v in sorted(items.items()):
                lines.append(f"{name}{_fmt_labels(dict(key))} {v:.9g}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


class LabelView(Mapping):
    """Live read-only mapping over one label dimension of a metric.

    ``LabelView(counter, "bucket")`` behaves like
    ``{128: 3, 256: 1}`` — keys are label values (int-parsed when
    possible), values are the summed counter for that label."""

    def __init__(self, metric: _Metric, label: str):
        self._metric = metric
        self._label = label

    def _materialize(self) -> dict:
        out = {}
        for key, v in self._metric.items().items():
            d = dict(key)
            if self._label not in d:
                continue
            raw = d[self._label]
            try:
                k = int(raw)
            except (TypeError, ValueError):
                k = raw
            out[k] = out.get(k, 0) + v
        return {k: _intify(v) for k, v in out.items()}

    def __getitem__(self, k):
        return self._materialize()[k]

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return len(self._materialize())

    def __repr__(self):
        return repr(self._materialize())

    def __eq__(self, other):
        return self._materialize() == other

    def __ne__(self, other):
        return not self.__eq__(other)


def _intify(v: float):
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


class StatsView(MutableMapping):
    """Dict-shaped facade over registry metrics.

    Maps legacy stats keys onto shared metric objects so existing call
    sites (``stats["cache_hits"] += 1``, ``dict(stats)``, ``stats.get``)
    keep working while the storage lives in a
    :class:`MetricsRegistry`.  Four key classes:

    * ``scalars``: key -> metric name; reads return the metric total
      (ints stay ints), writes set the absolute value.
    * ``labeled``: key -> (metric name, label) exposing a live
      :class:`LabelView` (e.g. ``oom_by_bucket``).
    * ``composite``: key -> zero-arg callable producing the value.
    * ``aux``: plain dict passthrough for irregular structures.
    """

    def __init__(self, registry: MetricsRegistry,
                 scalars: Dict[str, str],
                 labeled: Optional[Dict[str, Tuple[str, str]]] = None,
                 composite: Optional[Dict[str, Callable]] = None,
                 aux: Optional[dict] = None,
                 float_keys: Iterable[str] = ()):
        self._registry = registry
        self._scalars = dict(scalars)
        self._labeled = dict(labeled or {})
        self._composite = dict(composite or {})
        self._aux = aux if aux is not None else {}
        self._float_keys = set(float_keys) | {
            k for k in self._scalars if k.endswith("_s")}
        self._metrics: Dict[str, _Metric] = {}
        for key, name in self._scalars.items():
            self._metrics[key] = registry.counter(name)
        for key, (name, _lbl) in self._labeled.items():
            self._metrics[key] = registry.counter(name)

    # -- binding ------------------------------------------------------
    def attach(self, registry: MetricsRegistry) -> None:
        """Re-home every backing metric into ``registry`` (merging with
        same-named metrics already there) and keep serving reads/writes
        through the shared objects."""
        if registry is self._registry:
            return
        for key in list(self._metrics):
            self._metrics[key] = registry.adopt(self._metrics[key])
        self._registry = registry

    def metric(self, key: str) -> _Metric:
        return self._metrics[key]

    # -- MutableMapping -----------------------------------------------
    def __getitem__(self, key):
        if key in self._scalars:
            v = self._metrics[key].total()
            return v if key in self._float_keys else _intify(v)
        if key in self._labeled:
            return LabelView(self._metrics[key], self._labeled[key][1])
        if key in self._composite:
            return self._composite[key]()
        return self._aux[key]

    def __setitem__(self, key, value):
        if key in self._scalars:
            self._metrics[key].set(float(value))
        elif key in self._labeled or key in self._composite:
            raise TypeError(
                f"stats key {key!r} is registry-backed; bump the metric "
                "instead of assigning the view")
        else:
            self._aux[key] = value

    def __delitem__(self, key):
        if key in self._aux:
            del self._aux[key]
        else:
            raise TypeError(f"cannot delete registry-backed key {key!r}")

    def __iter__(self):
        seen = set()
        for src in (self._scalars, self._labeled, self._composite,
                    self._aux):
            for k in src:
                if k not in seen:
                    seen.add(k)
                    yield k

    def __len__(self):
        return sum(1 for _ in self)

    def __contains__(self, key):
        return (key in self._scalars or key in self._labeled
                or key in self._composite or key in self._aux)

    def __repr__(self):
        return repr({k: self[k] for k in self})

    # convenience: bump a scalar counter without read-modify-write
    def inc(self, key: str, n: float = 1.0, **labels) -> None:
        self._metrics[key].inc(n, **labels)
