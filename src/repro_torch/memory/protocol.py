"""The plan-store contract (the twin of ``repro.memory.protocol``).

* ``lookup_batch`` / ``insert_batch`` are the primitive operations: one
  lock acquisition, one batched fuzzy/semantic resolution, one device write
  per admission wave on the ``device`` index backend.
* ``lookup`` / ``insert`` are thin wrappers over them, provided once by
  :class:`PlanStoreBase`: a single request is a batch of one.
* ``contexts`` carry optional side-channel text per keyword (the raw task
  query) for stages that match on something other than the key.
* ``vectors`` let a caller that already embedded the keys pass them in.
* ``unless_written_since`` is conditional admission: a key whose live entry
  was (re)written at or after the token (``store.now()`` captured at the
  read the wave was derived from) is skipped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, TypeVar, runtime_checkable

from repro_torch.obs import MetricsRegistry
from repro_torch.obs import names as _names

V = TypeVar("V")


def _stat_prop(field: str):
    def get(self):
        v = self._counters[field].value
        return v if field == "lookup_time_s" else int(v)

    def set_(self, v):
        # the ``stats.hits += 1`` shim: get-then-set, safe only under the
        # owning store's lock; lock-free callers use ``add()``
        self._counters[field].set(v)

    return property(get, set_)


class CacheStats:
    """Hit/miss/insert/evict accounting for one plan store: a view over
    lock-safe counters of a :class:`repro_torch.obs.MetricsRegistry`, with
    the reference's field reads and ``snapshot()``. Stores that share a
    registry (the shards of a ``DistributedPlanCache``) are label-keyed
    series of one set; a bare ``CacheStats()`` has a private registry.
    The cold-tier and conditional-admission fields stay out of
    ``snapshot()``, as in the reference: ``cold_snapshot()`` reads them."""

    _FIELDS = {
        "hits": _names.CACHE_HITS,
        "misses": _names.CACHE_MISSES,
        "inserts": _names.CACHE_INSERTS,
        "evictions": _names.CACHE_EVICTIONS,
        "lookup_time_s": _names.CACHE_LOOKUP_TIME_S,
        "cold_hits": _names.CACHE_COLD_HITS,
        "spills": _names.CACHE_SPILLS,
        "promotes": _names.CACHE_PROMOTES,
        "compaction_saved_tokens": _names.CACHE_COMPACTION_SAVED_TOKENS,
        "stale_insert_skips": _names.CACHE_STALE_INSERT_SKIPS,
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None, **labels: str):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.labels = labels
        self._counters = {
            field: self.registry.counter(name, **labels)
            for field, name in self._FIELDS.items()
        }

    hits = _stat_prop("hits")
    misses = _stat_prop("misses")
    inserts = _stat_prop("inserts")
    evictions = _stat_prop("evictions")
    lookup_time_s = _stat_prop("lookup_time_s")
    cold_hits = _stat_prop("cold_hits")
    spills = _stat_prop("spills")
    promotes = _stat_prop("promotes")
    compaction_saved_tokens = _stat_prop("compaction_saved_tokens")
    stale_insert_skips = _stat_prop("stale_insert_skips")

    def add(self, field: str, n: float = 1) -> None:
        """Lock-safe increment (the contract for unlocked callers)."""
        self._counters[field].inc(n)

    def reset(self) -> None:
        """Zero this view's own series, not the whole registry."""
        for c in self._counters.values():
            c.reset()

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "inserts": self.inserts,
            "evictions": self.evictions,
            "lookup_time_s": round(self.lookup_time_s, 6),
        }

    def cold_snapshot(self) -> Dict[str, int]:
        """The tiered-memory counters (all 0 unless a cold tier is wired)."""
        return {
            "cold_hits": self.cold_hits,
            "spills": self.spills,
            "promotes": self.promotes,
            "compaction_saved_tokens": self.compaction_saved_tokens,
            "stale_insert_skips": self.stale_insert_skips,
        }


@runtime_checkable
class PlanStore(Protocol):
    """Batch-native keyword -> plan store: :class:`repro_torch.core.cache.PlanCache`
    and :class:`repro_torch.core.distributed_cache.DistributedPlanCache`.
    Consumers (router, agent methods, harness) program against this
    protocol; ``isinstance`` checks that the methods are there."""

    stats: CacheStats

    def lookup_batch(
        self,
        keywords: Sequence[str],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
    ) -> List[Optional[Any]]: ...

    def insert_batch(
        self,
        items: Sequence[Tuple[str, Any]],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
        vectors: Optional[Any] = None,
        unless_written_since: Optional[float] = None,
    ) -> None: ...

    def now(self) -> float: ...

    def lookup(self, keyword: str, *, context: Optional[str] = None) -> Optional[Any]: ...

    def insert(
        self,
        keyword: str,
        value: Any,
        *,
        context: Optional[str] = None,
        vector: Optional[Any] = None,
    ) -> None: ...

    def remove(self, keyword: str) -> bool: ...

    def keys(self) -> List[str]: ...

    def clear(self) -> None: ...

    def __contains__(self, keyword: str) -> bool: ...

    def __len__(self) -> int: ...


class PlanStoreBase:
    """Singular ``lookup``/``insert`` as thin wrappers over the batch
    primitives — inherit this and implement ``lookup_batch`` /
    ``insert_batch``."""

    def lookup(self, keyword: str, *, context: Optional[str] = None) -> Optional[Any]:
        return self.lookup_batch([keyword], contexts=[context])[0]

    def insert(
        self,
        keyword: str,
        value: Any,
        *,
        context: Optional[str] = None,
        vector: Optional[Any] = None,
        unless_written_since: Optional[float] = None,
    ) -> None:
        self.insert_batch(
            [(keyword, value)],
            contexts=[context],
            vectors=None if vector is None else [vector],
            unless_written_since=unless_written_since,
        )


__all__ = ["CacheStats", "PlanStore", "PlanStoreBase", "V"]
