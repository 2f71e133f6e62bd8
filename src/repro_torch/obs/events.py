"""Structured event log: schema-versioned JSONL with a bounded ring.

Every discrete runtime *decision* is recorded here with provenance —
plan creation (bucket, source, predicted vs. actual peak bytes), solver
swaps, cache evictions and OOM poisonings, serve admissions/defers/
rejects, snapshot writes/restores, drift audits and refits.  The ring
buffer (``collections.deque(maxlen=...)``) keeps the newest events
in-memory for reports; an optional file sink streams every event to
JSONL for offline analysis.  A copy of the reference's ``obs/events.py``.

Schema: every record is one JSON object per line with at least
``{"v": SCHEMA_VERSION, "ts": <float seconds>, "kind": <str>}`` plus
kind-specific fields.  Unknown fields must be ignored by readers so the
schema can grow additively.
"""
from __future__ import annotations

import io
import json
import time
from collections import deque
from typing import Iterator, List, Optional

__all__ = ["SCHEMA_VERSION", "EventLog", "NullEventLog", "read_events"]

SCHEMA_VERSION = 1


class EventLog:
    """Bounded in-memory ring of events with an optional JSONL sink."""

    enabled = True

    def __init__(self, capacity: int = 4096, path: Optional[str] = None,
                 clock=time.time):
        self._ring: deque = deque(maxlen=int(capacity))
        self._clock = clock
        self._path = path
        self._sink: Optional[io.TextIOBase] = None
        if path:
            self._sink = open(path, "w", buffering=1 << 16)

    def emit(self, kind: str, **fields) -> dict:
        rec = {"v": SCHEMA_VERSION, "ts": self._clock(), "kind": kind}
        rec.update(fields)
        self._ring.append(rec)
        if self._sink is not None:
            self._sink.write(json.dumps(rec, default=_jsonable) + "\n")
        return rec

    def tail(self, n: Optional[int] = None,
             kind: Optional[str] = None) -> List[dict]:
        evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs[-n:] if n else evs

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            self._sink.close()
            self._sink = None

    def __len__(self):
        return len(self._ring)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullEventLog:
    """Disabled event log: ``emit`` is a constant no-op."""

    enabled = False

    def emit(self, kind: str, **fields) -> None:  # pragma: no cover
        return None

    def tail(self, n=None, kind=None) -> List[dict]:
        return []

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None

    def __len__(self):
        return 0


def read_events(path: str, kind: Optional[str] = None) -> Iterator[dict]:
    """Stream events back from a JSONL file, skipping malformed lines
    (a truncated final line after a crash must not poison analysis)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            yield rec


def _jsonable(o):
    """Fallback serializer: numpy scalars and arrays degrade to plain
    Python numbers/lists instead of crashing the sink."""
    if hasattr(o, "tolist"):          # arrays AND numpy scalars
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    return str(o)
