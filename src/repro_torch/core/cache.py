"""The plan cache: keyword -> plan template, exact match, LRU eviction
(trimmed copy of ``repro.core.cache.PlanCache``).

The paper's default store (§3.2, Table 4): an exact keyword lookup and
least-recently-used eviction at ``capacity``. The reference's match
pipeline, fuzzy/semantic stages, cold tier and metrics registry are not on
this path and are not copied; the accounting that the ``apc`` method and
the serve entry point read (hits, misses, inserts, evictions) is kept.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0


class PlanCache:
    """keyword -> plan-template store, exact match + LRU.

    Thread-safe: one lock guards the store and its recency order.
    """

    def __init__(self, capacity: int = 100):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # insertion-ordered recency list: least recently used first
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def lookup(self, keyword: str) -> Optional[Any]:
        """Exact match; a hit refreshes the entry's recency."""
        with self._lock:
            if keyword not in self._store:
                self.stats.misses += 1
                return None
            self._store.move_to_end(keyword)
            self.stats.hits += 1
            return self._store[keyword]

    def insert(self, keyword: str, value: Any) -> None:
        """Insert or overwrite; evicts least-recently-used entries past
        ``capacity`` after the write lands."""
        with self._lock:
            self._store.pop(keyword, None)
            self._store[keyword] = value
            self.stats.inserts += 1
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.stats.evictions += 1

    def __contains__(self, keyword: str) -> bool:
        with self._lock:
            return keyword in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
