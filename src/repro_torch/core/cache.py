"""The plan cache: a batch-native plan store with composable eviction
policies, a pluggable match pipeline and an optional cold tier (the twin of
``repro.core.cache.PlanCache``).

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

With ``cold_dir`` set, eviction victims spill to a
:class:`~repro_torch.memory.tiered.ColdTier` (one segment a wave) instead
of vanishing, and a lookup that every stage missed tries the cold tier's
manifest on the exact key, promoting a hit back through ``insert_batch``.

Accounting lands in a :class:`repro_torch.obs.MetricsRegistry` (``obs``,
labelled ``obs_labels``: the shards of a ``DistributedPlanCache`` share the
facade's registry with a ``shard=<name>`` label). Under a tracer a lookup
opens ``cache.lookup_batch`` with one ``match.stage`` span a stage (the
cold tier's ``stage="cold"``), an insert ``cache.insert_batch``, a spill
``cache.spill`` and a promotion ``cache.promote``, and every resolved query
deposits its stage and matched key into the open attribution collector
(:mod:`repro_torch.obs.attribution`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, Tuple, Union

from repro_torch.memory.pipeline import build_pipeline
from repro_torch.memory.policies import CacheEntry, EvictionPolicy, make_policy
from repro_torch.memory.protocol import CacheStats, PlanStoreBase, V
from repro_torch.memory.tiered import ColdTier
from repro_torch.obs import MetricsRegistry, deposit, trace_span
from repro_torch.obs.names import (
    SPAN_CACHE_INSERT,
    SPAN_CACHE_LOOKUP,
    SPAN_CACHE_PROMOTE,
    SPAN_CACHE_SPILL,
    SPAN_MATCH_STAGE,
)


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
        cold_dir: Optional[str] = None,
        cold_budget_tokens: int = 160,
        cold_keep_last: int = 8,
        cold_refcount_gc: bool = True,
        obs: Optional[MetricsRegistry] = None,
        obs_labels: Optional[Dict[str, str]] = None,
    ):
        self.capacity = capacity
        # injectable time source: TTL expiry, entry timestamps and `now()`
        # read this, never the wall clock directly
        self._clock = clock if clock is not None else time.time
        self.policy = make_policy(eviction, ttl_s=ttl_s)
        self.obs = obs if obs is not None else MetricsRegistry()
        self.obs_labels = dict(obs_labels or {})
        if pipeline is None:
            pipeline = ("exact", "fuzzy") if fuzzy else ("exact",)
        self.pipeline = build_pipeline(
            pipeline,
            fuzzy_threshold=fuzzy_threshold,
            semantic_threshold=semantic_threshold,
            index_backend=index_backend,
            device=device,
            obs=self.obs,
            obs_labels=self.obs_labels,
        )
        self._store: Dict[str, CacheEntry] = {}
        # delete hooks, called with the keyword for every removal (eviction,
        # remove(), clear(), overwrite); they run under the cache lock and
        # must not call back into this cache
        self._evict_listeners: List[Callable[[str], None]] = []
        self._lock = threading.RLock()
        self.stats = CacheStats(self.obs, **self.obs_labels)
        # the cold persistent tier: victims spill to segments on disk and
        # hot misses promote back through insert_batch; None: no cold tier
        self.cold: Optional[ColdTier] = None if cold_dir is None else ColdTier(
            cold_dir, budget_tokens=cold_budget_tokens, keep_last=cold_keep_last,
            refcount_gc=cold_refcount_gc)

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
            with trace_span(SPAN_CACHE_LOOKUP, n=len(keywords),
                            **self.obs_labels) as lsp, self._lock:
                now = self._clock()
                out: List[Optional[V]] = [None] * len(keywords)
                pending = list(range(len(keywords)))
                hits = 0
                for stage in self.pipeline.stages:
                    if not pending:
                        break
                    with trace_span(SPAN_MATCH_STAGE, stage=stage.name,
                                    pending=len(pending)) as ssp:
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
                                # attribution: the stage that resolved batch
                                # index i, and the stored key it matched
                                deposit(i, stage=stage.name, matched_key=alt)
                        ssp.set(resolved=len(pending) - len(still))
                        pending = still
                if pending and self.cold is not None:
                    # the cold tier resolves exact keys only, through its
                    # manifest; a hit is promoted (one wave a key, in batch
                    # order) and served from the hot tier
                    with trace_span(SPAN_MATCH_STAGE, stage="cold",
                                    pending=len(pending)) as ssp:
                        still = []
                        for i in pending:
                            kw = keywords[i]
                            v = self._promote(kw, now) if kw in self.cold else None
                            if v is None:
                                still.append(i)
                            else:
                                out[i] = v
                                deposit(i, stage="cold", matched_key=kw, cache_tier="cold")
                                self.stats.add("cold_hits")
                        ssp.set(resolved=len(pending) - len(still))
                        pending = still
                for v in out:
                    if v is None:
                        self.stats.misses += 1
                    else:
                        self.stats.hits += 1
                        hits += 1
                lsp.set(hits=hits)
                return out
        finally:
            # lock-safe increment outside the lock: concurrent waves may
            # share one registry
            self.stats.add("lookup_time_s", time.perf_counter() - t0)

    def _get_live(self, keyword: str, now: float) -> Optional[V]:
        """Serve one exact key: TTL-expire, count the hit, touch the policy."""
        entry = self._store.get(keyword)
        if entry is None:
            return None
        if self.policy.expired(keyword, entry, now):
            # an expiry is a delete, never a spill: a stale entry must not
            # come back from the cold tier
            self._delete(keyword)
            return None
        entry.hits += 1
        self.policy.on_access(keyword, entry)
        return entry.value

    def _promote(self, keyword: str, now: float) -> Optional[V]:
        """Move one cold entry back to the hot tier and serve it: the
        manifest entry is consumed and the value goes through
        ``insert_batch`` like a fresh insert (its cascading eviction may
        spill a colder victim, or this key again). None when the manifest
        was stale or the entry did not survive its own admission wave."""
        got = self.cold.take([keyword])[0]
        if got is None:
            return None
        with trace_span(SPAN_CACHE_PROMOTE, key=keyword, **self.obs_labels):
            self.insert_batch([(keyword, got.value)], contexts=[got.context],
                              vectors=None if got.vector is None else [got.vector])
            self.stats.add("promotes")
        return self._get_live(keyword, now)

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
        so a wave larger than ``capacity`` keeps its newest entries; with a
        cold tier the wave's victims spill as one segment at wave end. Keys
        whose live entry was (re)written at or after
        ``unless_written_since`` are skipped.
        """
        items = list(items)
        if contexts is None:
            contexts = [None] * len(items)
        with trace_span(SPAN_CACHE_INSERT, n=len(items), **self.obs_labels), self._lock:
            now = self._clock()
            kept: List[int] = []
            for idx, (kw, v) in enumerate(items):
                if unless_written_since is not None:
                    existing = self._store.get(kw)
                    if existing is not None and existing.inserted_at >= unless_written_since:
                        self.stats.add("stale_insert_skips")
                        continue
                kept.append(idx)
                if kw in self._store:
                    # an overwrite is delete + insert: listeners must see
                    # the old entry go
                    self._delete(kw)
                entry = CacheEntry(v, now, context=contexts[idx],
                                   vector=None if vectors is None else vectors[idx])
                self._store[kw] = entry
                self.policy.on_insert(kw, entry)
                self.stats.inserts += 1
            if kept:
                self.pipeline.on_insert_batch(
                    [items[i] for i in kept],
                    [contexts[i] for i in kept],
                    None if vectors is None else [vectors[i] for i in kept],
                )
            victims: List[Tuple[str, CacheEntry]] = []
            while len(self._store) > self.capacity:
                vk = self.policy.victim(self._store)
                victims.append((vk, self._store[vk]))
                self._delete(vk)
                self.stats.evictions += 1
            if victims and self.cold is not None:
                self._spill(victims)

    def _spill(self, victims: List[Tuple[str, CacheEntry]]) -> None:
        """One spill wave (an insert wave's victims) to the cold tier:
        compaction, segment write, manifest commit."""
        with trace_span(SPAN_CACHE_SPILL, n=len(victims), **self.obs_labels) as sp:
            saved = self.cold.spill([
                (kw, e.value, e.context, e.vector,
                 float(e.hits + getattr(e.value, "uses", 0)))
                for kw, e in victims
            ])
            self.stats.add("spills", len(victims))
            if saved:
                self.stats.add("compaction_saved_tokens", saved)
            sp.set(saved_tokens=saved)

    def peek(self, keyword: str) -> Optional[V]:
        """The value of an exact key without hit accounting or policy
        touches (an expired entry reads None): read-repair must not perturb
        recency or frequency."""
        with self._lock:
            entry = self._store.get(keyword)
            if entry is None or self.policy.expired(keyword, entry, self._clock()):
                return None
            return entry.value

    def snapshot_items(self) -> List[Tuple[str, V]]:
        """Every live (keyword, value) pair under one lock acquisition, with
        ``peek`` semantics: the scan behind re-homing and read-repair in the
        distributed cache."""
        with self._lock:
            now = self._clock()
            return [(k, e.value) for k, e in self._store.items()
                    if not self.policy.expired(k, e, now)]

    def remove(self, keyword: str) -> bool:
        """Delete one entry, keeping stage indexes in sync. True if present
        in either tier: a removed key must not come back from the cold
        manifest on a later miss."""
        with self._lock:
            purged = self.cold.purge(keyword) if self.cold is not None else False
            if keyword not in self._store:
                return purged
            self._delete(keyword)
            return True

    def autotune(self, **thresholds) -> List[str]:
        """One auto-tuning step for every stage index that supports it (LSH
        ``n_bits``/``probe_hamming`` from live telemetry); returns the
        actions taken, e.g. ``["fuzzy:n_bits->14"]``."""
        with self._lock:
            actions: List[str] = []
            for stage in self.pipeline.stages:
                tune = getattr(stage, "autotune", None)
                if tune is not None:
                    act = tune(**thresholds)
                    if act:
                        actions.append(f"{stage.name}:{act}")
            return actions

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
            # reset, not rebuild: the stats are a view over a registry that
            # may be shared
            self.stats.reset()
            self.policy.reset()
            self.pipeline.clear()
            if self.cold is not None:
                self.cold.clear()

    # -- serialization (checkpoint/restore of the test-time memory) --------

    def to_state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": [(k, e.value) for k, e in self._store.items()],
            }


__all__ = ["CacheStats", "PlanCache"]
