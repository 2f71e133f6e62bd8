"""Bounded LRU cache for step functions and cached plans.

A copy of the reference's ``LRUCache``: dict-compatible for the
operations the call sites use, evicting the least recently used entry
once ``maxsize`` is exceeded and counting evictions.  Reads refresh
recency.  Not thread-safe — the training loop is single-threaded.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Iterator


class LRUCache:
    """A dict with bounded size and least-recently-used eviction."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.evictions = 0
        self._data: "OrderedDict[Any, Any]" = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        self._data.move_to_end(key)          # touch: reads refresh recency
        return self._data[key]

    def __setitem__(self, key, value):
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)   # least recently used
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def get(self, key, default=None):
        if key in self._data:
            return self[key]
        return default

    def keys(self):
        return self._data.keys()

    def pop(self, key, default=None):
        """Remove one entry; explicit invalidation is not an eviction."""
        return self._data.pop(key, default)

    def clear(self) -> None:
        """Drop every entry; evictions count only capacity removals."""
        self._data.clear()
