"""The plan cache: a batch-native plan store with composable eviction
policies and a pluggable match pipeline (the twin of
``repro.core.cache.PlanCache``, without the cold tier and metrics registry).

``lookup_batch``/``insert_batch`` are the primitives (one lock acquisition,
one batched fuzzy/semantic resolution, one device write per admission wave
on the ``device`` index backend); the singular ``lookup``/``insert`` come
from ``PlanStoreBase``.

Matching is a :class:`~repro_torch.memory.pipeline.MatchPipeline`: exact
dict membership by default, exact -> fuzzy with ``fuzzy=True`` (the paper's
Tables 5-6 configuration, searched by the ``index_backend``: ``brute`` |
``bucketed`` | ``auto`` on the host, ``pallas`` | ``device`` on ``device``),
or any cascade of stage names via ``pipeline=("exact", "fuzzy",
"semantic")``. Stage indexes are kept up to date under the cache lock on
insert, eviction and TTL expiry.

Eviction is an :class:`~repro_torch.memory.policies.EvictionPolicy`
(``eviction="lru" | "lfu" | "cost"`` or an instance); ``ttl_s`` wraps the
chosen policy in TTL expiry, applied on the lookup path.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, Tuple, Union

from repro_torch.memory.pipeline import build_pipeline
from repro_torch.memory.policies import CacheEntry, EvictionPolicy, make_policy
from repro_torch.memory.protocol import CacheStats, PlanStoreBase, V


class PlanCache(PlanStoreBase, Generic[V]):
    """keyword -> plan-template store with pluggable eviction and matching.

    Thread-safe: one re-entrant lock guards the store, the policy and the
    stage indexes. A capacity of 0 admits nothing: every insert is evicted
    at once (a store that never reuses).
    """

    def __init__(
        self,
        capacity: int = 100,
        *,
        fuzzy: bool = False,
        fuzzy_threshold: float = 0.8,
        semantic_threshold: float = 0.85,
        index_backend: str = "auto",
        ttl_s: Optional[float] = None,
        eviction: Union[str, EvictionPolicy] = "lru",
        pipeline: Optional[Sequence[str]] = None,
        clock: Optional[Callable[[], float]] = None,
        device=None,
    ):
        self.capacity = capacity
        # injectable time source: TTL expiry, entry timestamps and `now()`
        # read this, never the wall clock directly
        self._clock = clock if clock is not None else time.time
        self.policy = make_policy(eviction, ttl_s=ttl_s)
        if pipeline is None:
            pipeline = ("exact", "fuzzy") if fuzzy else ("exact",)
        self.pipeline = build_pipeline(
            pipeline,
            fuzzy_threshold=fuzzy_threshold,
            semantic_threshold=semantic_threshold,
            index_backend=index_backend,
            device=device,
        )
        self._store: Dict[str, CacheEntry] = {}
        # delete hooks, called with the keyword for every removal (eviction,
        # remove(), clear(), overwrite); they run under the cache lock and
        # must not call back into this cache
        self._evict_listeners: List[Callable[[str], None]] = []
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def now(self) -> float:
        """The store's clock: capture this before a read whose derived wave
        will be inserted with ``unless_written_since``."""
        return self._clock()

    # -- core ops ----------------------------------------------------------

    def lookup_batch(
        self,
        keywords: Sequence[str],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
    ) -> List[Optional[V]]:
        """Answer a whole batch of lookups in one pipeline walk: each stage
        resolves the still-unresolved queries in one batched call (one top-k
        launch for a fuzzy/semantic stage on the ``pallas``/``device``
        backends); a resolved key is served through the one exact path."""
        t0 = time.perf_counter()
        if contexts is None:
            contexts = [None] * len(keywords)
        try:
            with self._lock:
                now = self._clock()
                out: List[Optional[V]] = [None] * len(keywords)
                pending = list(range(len(keywords)))
                for stage in self.pipeline.stages:
                    if not pending:
                        break
                    alts = stage.resolve(
                        [keywords[i] for i in pending],
                        [contexts[i] for i in pending],
                        self._store.__contains__,
                    )
                    still: List[int] = []
                    for i, alt in zip(pending, alts):
                        v = None if alt is None else self._get_live(alt, now)
                        if v is None:
                            still.append(i)
                        else:
                            out[i] = v
                    pending = still
                for v in out:
                    if v is None:
                        self.stats.misses += 1
                    else:
                        self.stats.hits += 1
                return out
        finally:
            with self._lock:
                self.stats.lookup_time_s += time.perf_counter() - t0

    def _get_live(self, keyword: str, now: float) -> Optional[V]:
        """Serve one exact key: TTL-expire, count the hit, touch the policy."""
        entry = self._store.get(keyword)
        if entry is None:
            return None
        if self.policy.expired(keyword, entry, now):
            self._delete(keyword)  # an expiry is a delete, not an eviction
            return None
        entry.hits += 1
        self.policy.on_access(keyword, entry)
        return entry.value

    def add_evict_listener(self, fn: Callable[[str], None]) -> None:
        """Register a delete hook (see ``_evict_listeners``)."""
        with self._lock:
            self._evict_listeners.append(fn)

    def _delete(self, keyword: str) -> None:
        del self._store[keyword]
        self.policy.on_remove(keyword)
        self.pipeline.on_remove(keyword)
        for fn in self._evict_listeners:
            fn(keyword)

    def insert_batch(
        self,
        items: Sequence[Tuple[str, V]],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
        vectors: Optional[Any] = None,
        unless_written_since: Optional[float] = None,
    ) -> None:
        """Insert a whole admission wave under one lock acquisition.

        Stages ingest the wave batched. Eviction runs after the wave lands,
        so a wave larger than ``capacity`` keeps its newest entries. Keys
        whose live entry was (re)written at or after
        ``unless_written_since`` are skipped.
        """
        items = list(items)
        if contexts is None:
            contexts = [None] * len(items)
        with self._lock:
            now = self._clock()
            kept: List[int] = []
            for idx, (kw, v) in enumerate(items):
                if unless_written_since is not None:
                    existing = self._store.get(kw)
                    if existing is not None and existing.inserted_at >= unless_written_since:
                        self.stats.stale_insert_skips += 1
                        continue
                kept.append(idx)
                if kw in self._store:
                    # an overwrite is delete + insert: listeners must see
                    # the old entry go
                    self._delete(kw)
                entry = CacheEntry(v, now)
                self._store[kw] = entry
                self.policy.on_insert(kw, entry)
                self.stats.inserts += 1
            if kept:
                self.pipeline.on_insert_batch(
                    [items[i] for i in kept],
                    [contexts[i] for i in kept],
                    None if vectors is None else [vectors[i] for i in kept],
                )
            while len(self._store) > self.capacity:
                self._delete(self.policy.victim(self._store))
                self.stats.evictions += 1

    def remove(self, keyword: str) -> bool:
        """Delete one entry, keeping stage indexes in sync; True if present."""
        with self._lock:
            if keyword not in self._store:
                return False
            self._delete(keyword)
            return True

    def __contains__(self, keyword: str) -> bool:
        with self._lock:
            return keyword in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._store)

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._store)
            self._store.clear()
            for kw in dropped:
                for fn in self._evict_listeners:
                    fn(kw)
            self.stats.reset()
            self.policy.reset()
            self.pipeline.clear()


__all__ = ["CacheStats", "PlanCache"]
