"""Composable eviction policies for plan stores (paper §4.4; the twin of
``repro.memory.policies``, without the cold tier's entry fields).

* ``lru``  — least-recently-used, O(1) victim selection (the paper default);
* ``lfu``  — least-frequently-used on the store's live hit counters;
* ``ttl``  — entries expire ``ttl_s`` after insert; wraps an inner policy
  that picks capacity victims (``PlanCache(ttl_s=...)`` builds this wrap);
* ``cost`` — cost-aware: score each entry by the tokens a reuse saves times
  how often it is reused, ``(1 + reuses) * tokens_saved``, where
  ``reuses`` counts live store hits plus the value's own ``uses`` counter
  and ``tokens_saved`` is ``value.size_tokens()`` where the value has one
  (1 otherwise). The entry with the least expected savings is evicted.

The store drives the policy through five hooks (``on_insert`` /
``on_access`` / ``on_remove`` / ``expired`` / ``victim``); policies keep
only derived bookkeeping and the store's entry dict stays the single
source of truth.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union


@dataclass
class CacheEntry:
    """One live store entry plus the accounting eviction policies read."""

    value: Any
    inserted_at: float
    hits: int = 0  # lookups served by this entry since (re)insert


class EvictionPolicy:
    """Base policy: no expiry, no victim preference (subclasses decide)."""

    name = "none"

    def reset(self) -> None:
        pass

    def on_insert(self, key: str, entry: CacheEntry) -> None:
        pass

    def on_access(self, key: str, entry: CacheEntry) -> None:
        pass

    def on_remove(self, key: str) -> None:
        pass

    def expired(self, key: str, entry: CacheEntry, now: float) -> bool:
        return False

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        """Key to evict when the store is over capacity. ``entries`` is the
        store's live dict (insertion-ordered); must not mutate it."""
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Least-recently-used; O(1) victim via a private recency list."""

    name = "lru"

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

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        return next(iter(self._order))


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used on live hit counts; oldest breaks ties. The
    victim is found by a scan of the entries (O(N)): stores evict rarely."""

    name = "lfu"

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        return min(entries, key=lambda k: (entries[k].hits, entries[k].inserted_at))


class CostAwarePolicy(EvictionPolicy):
    """Evict the entry with the least expected tokens saved (paper §4.4)."""

    name = "cost"

    @staticmethod
    def score(entry: CacheEntry) -> float:
        reuses = entry.hits + getattr(entry.value, "uses", 0)
        tokens_saved = 1
        size_fn = getattr(entry.value, "size_tokens", None)
        if callable(size_fn):
            tokens_saved = max(1, int(size_fn()))
        return float((1 + reuses) * tokens_saved)

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        return min(
            entries,
            key=lambda k: (self.score(entries[k]), entries[k].inserted_at),
        )


class TTLPolicy(EvictionPolicy):
    """Expire entries ``ttl_s`` after insert; delegate capacity pressure to
    an inner policy (LRU unless composed otherwise)."""

    name = "ttl"

    def __init__(self, ttl_s: float, inner: Optional[EvictionPolicy] = None):
        self.ttl_s = float(ttl_s)
        self.inner = inner if inner is not None else LRUPolicy()

    def reset(self) -> None:
        self.inner.reset()

    def on_insert(self, key: str, entry: CacheEntry) -> None:
        self.inner.on_insert(key, entry)

    def on_access(self, key: str, entry: CacheEntry) -> None:
        self.inner.on_access(key, entry)

    def on_remove(self, key: str) -> None:
        self.inner.on_remove(key)

    def expired(self, key: str, entry: CacheEntry, now: float) -> bool:
        return now - entry.inserted_at > self.ttl_s

    def victim(self, entries: Dict[str, CacheEntry]) -> str:
        return self.inner.victim(entries)


EVICTION_POLICIES = {
    "lru": LRUPolicy,
    "lfu": LFUPolicy,
    "cost": CostAwarePolicy,
}


def make_policy(
    spec: Union[str, EvictionPolicy] = "lru",
    *,
    ttl_s: Optional[float] = None,
) -> EvictionPolicy:
    """Resolve a policy spec; a ``ttl_s`` wraps the result in TTL expiry.

    ``spec`` is a registered name (``lru`` | ``lfu`` | ``cost`` | ``ttl``)
    or an already-built :class:`EvictionPolicy` (never share one instance
    between stores: its bookkeeping is per store).
    """
    if isinstance(spec, EvictionPolicy):
        policy = spec
    elif spec == "ttl":
        if ttl_s is None:
            raise ValueError("eviction='ttl' requires ttl_s")
        return TTLPolicy(ttl_s)
    elif spec in EVICTION_POLICIES:
        policy = EVICTION_POLICIES[spec]()
    else:
        raise ValueError(
            f"unknown eviction policy {spec!r}; registered: "
            f"{sorted(EVICTION_POLICIES) + ['ttl']}"
        )
    if ttl_s is not None and not isinstance(policy, TTLPolicy):
        policy = TTLPolicy(ttl_s, policy)
    return policy


__all__ = [
    "CacheEntry",
    "CostAwarePolicy",
    "EVICTION_POLICIES",
    "EvictionPolicy",
    "LFUPolicy",
    "LRUPolicy",
    "TTLPolicy",
    "make_policy",
]
