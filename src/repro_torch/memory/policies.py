"""The plan store's entry record and its eviction policy (from
``repro.memory.policies``, LRU only).

The store drives the policy through four hooks (``on_insert`` /
``on_access`` / ``on_remove`` / ``victim``); the policy keeps
only derived bookkeeping and the store's entry dict stays the single source
of truth. The reference's ``lfu``, ``cost`` and ``ttl`` policies are not
ported yet.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any


@dataclass
class CacheEntry:
    """One live store entry plus the accounting eviction policies read."""

    value: Any
    inserted_at: float
    hits: int = 0  # lookups served by this entry since (re)insert


class LRUPolicy:
    """Least-recently-used; O(1) victim via a private recency list."""

    def __init__(self) -> None:
        self._order: "OrderedDict[str, None]" = OrderedDict()

    def reset(self) -> None:
        self._order.clear()

    def on_insert(self, key: str, entry: CacheEntry) -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def on_access(self, key: str, entry: CacheEntry) -> None:
        if key in self._order:
            self._order.move_to_end(key)

    def on_remove(self, key: str) -> None:
        self._order.pop(key, None)

    def victim(self) -> str:
        """The key to evict when the store is over capacity."""
        return next(iter(self._order))


__all__ = ["CacheEntry", "LRUPolicy"]
