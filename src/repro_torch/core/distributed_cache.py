"""Distributed plan cache: consistent-hash sharding and replication (the
twin of ``repro.core.distributed_cache``).

Keywords are sharded across cache nodes by a consistent-hash ring (virtual
nodes; the reference's blake2b hash, so both packages give a key the same
owners), so adding or removing a node moves only ~K/N keys. Each key is
replicated onto R successive ring nodes; reads fall through replicas when a
node fails, writes go to every live replica.

``DistributedPlanCache`` is a plan store like ``PlanCache``. Each shard is a
full ``PlanCache``, so with ``fuzzy=True`` every shard owns a similarity
index over its own keys; ``index_backend="device"`` gives each shard its own
bank on ``device`` (CUDA unless the caller asks for another), and a lookup
wave fans out as one top-k kernel call per probed shard and replica tier.
Eviction policy and TTL are forwarded to every shard. A replicated write
embeds each key once: the facade embeds the wave and ships ``(key, vector)``
pairs to every replica.

In-process shards stand in for network nodes; the interface (lookup /
insert / add_node / remove_node / mark_down / restart_node) is what a
networked implementation would expose.

* Every per-shard call goes through the ``interceptor`` seam
  (``interceptor.call(node, op, fn)``), where a networked deployment would
  put its RPC client; an interceptor may raise :class:`ShardUnavailable` (a
  crash found at call time, unlike ``mark_down``, which the membership layer
  already knows).
* Crash fallthrough: when a shard call fails mid-lookup, its keywords stay
  pending and fall through to the next replica tier.
* Synchronous replica acks (``ack_policy="all"``): ``insert_batch`` returns
  only after every live owner applied the wave.
* Crash recovery: ``restart_node`` brings a node back empty — a fresh shard,
  whose device bank replaces (and frees) the old one — and with
  ``recover=True`` read-repairs the keys it owns from its peers.
* Churn re-homing: ``add_node`` re-homes keys whose owner set changed
  (``_rebalance``); ``remove_node`` drains a leaving node's keys to their
  new owners first.
* Fuzzy scatter: with fuzzy shards a lookup probes the ring owners and then
  every other live shard, since a similar key hashes to its own owners.

Control-plane operations (``keys``/``__len__``/``autotune``/``clear`` and
the scans behind re-homing and repair) pay the same seam; an unreachable
shard is skipped.

With ``cold_dir`` every shard gets its own cold tier
(``memory/tiered.py``) in ``<cold_dir>/<node>``: spill and promote stay
shard-local, under the same seam as the lookup and insert calls that
trigger them. ``arm_cold_crash`` is the fault seam of every shard's tier.

Not ported yet: the deterministic simulation's seams (``ablate``,
``ack_policy="primary"``); passing either raises.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import CacheStats, PlanCache
from repro_torch.index.bank import embed, embed_batch
from repro_torch.memory.protocol import PlanStoreBase
from repro_torch.obs import MetricsRegistry, collect, deposit, trace_span
from repro_torch.obs.names import (
    SPAN_DCACHE_INSERT,
    SPAN_DCACHE_LOOKUP,
    SPAN_DCACHE_TIER,
    SPAN_SHARD_CALL,
)


class ShardUnavailable(RuntimeError):
    """A shard call failed at dispatch time (crash discovered by the RPC
    layer, not yet by membership). Raised by interceptors, never by the
    in-process shards themselves."""


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class HashRing:
    def __init__(self, vnodes: int = 64):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, str]] = []
        self._nodes: set = set()

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.vnodes):
            self._ring.append((_hash(f"{node}#{v}"), node))
        self._ring.sort()

    def remove(self, node: str) -> None:
        self._nodes.discard(node)
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def nodes_for(self, key: str, r: int = 1) -> List[str]:
        """r distinct nodes clockwise from the key's hash."""
        if not self._ring:
            return []
        h = _hash(key)
        i = bisect.bisect_right(self._ring, (h, "￿")) % len(self._ring)
        out: List[str] = []
        j = i
        while len(out) < min(r, len(self._nodes)):
            node = self._ring[j % len(self._ring)][1]
            if node not in out:
                out.append(node)
            j += 1
        return out

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)


class DistributedPlanCache(PlanStoreBase):
    """Plan-store facade over sharded, replicated cache nodes."""

    def __init__(
        self,
        n_nodes: int = 4,
        *,
        replication: int = 2,
        capacity_per_node: int = 64,
        fuzzy: bool = False,
        fuzzy_threshold: float = 0.8,
        index_backend: str = "auto",
        eviction: str = "lru",
        ttl_s: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
        interceptor: Optional[Any] = None,
        ack_policy: str = "all",
        cold_dir: Optional[str] = None,
        cold_budget_tokens: int = 160,
        cold_keep_last: int = 8,
        device=None,
        obs: Optional[MetricsRegistry] = None,
        **deferred: Any,
    ):
        if deferred:
            raise TypeError(
                f"DistributedPlanCache does not take {sorted(deferred)} yet: the "
                "simulation's ablate= is not ported"
            )
        if not isinstance(eviction, str):
            # a policy instance would be bookkeeping shared across shards
            raise TypeError("DistributedPlanCache takes an eviction policy name")
        if ack_policy != "all":
            raise ValueError(
                f"ack_policy must be 'all', got {ack_policy!r} (the simulation's "
                "'primary' ablation is not ported)"
            )
        self.ring = HashRing()
        self.replication = replication
        self.capacity_per_node = capacity_per_node
        # each shard owns a similarity index over its own keys; lookups fan
        # out by shard, so a fuzzy scan never spans the global key set
        self.fuzzy = fuzzy
        self.fuzzy_threshold = fuzzy_threshold
        self.index_backend = index_backend
        self.eviction = eviction
        self.ttl_s = ttl_s
        # every time read goes through self.clock(), shared with the shards
        self.clock = clock if clock is not None else time.time
        self.interceptor = interceptor
        self.ack_policy = ack_policy
        self.cold_dir = cold_dir
        self.cold_budget_tokens = cold_budget_tokens
        self.cold_keep_last = cold_keep_last
        self.device = device
        self.shards: Dict[str, PlanCache] = {}
        self.down: set = set()
        # one registry spans the facade and every shard: shard series carry
        # a ``shard=<name>`` label, the facade's aggregate stats none
        self.obs = obs if obs is not None else MetricsRegistry()
        self.stats = CacheStats(self.obs)
        self._lock = threading.RLock()
        for i in range(n_nodes):
            self.add_node(f"cache-{i}")

    # -- membership (elastic scaling) -----------------------------------

    def _new_shard(self, name: str) -> PlanCache:
        return PlanCache(
            capacity=self.capacity_per_node,
            fuzzy=self.fuzzy,
            fuzzy_threshold=self.fuzzy_threshold,
            index_backend=self.index_backend,
            eviction=self.eviction,
            ttl_s=self.ttl_s,
            clock=self.clock,
            device=self.device,
            cold_dir=None if self.cold_dir is None else os.path.join(self.cold_dir, name),
            cold_budget_tokens=self.cold_budget_tokens,
            cold_keep_last=self.cold_keep_last,
            obs=self.obs,
            obs_labels={"shard": name},
        )

    def add_node(self, name: str) -> None:
        with self._lock:
            if name in self.shards:
                self.down.discard(name)
                return
            self.shards[name] = self._new_shard(name)
            self.ring.add(name)
            # a join re-homes the keys whose owner set the ring change moved
            self._rebalance()

    def remove_node(self, name: str) -> None:
        """Graceful removal: re-home this node's keys before dropping it.
        The drain scan goes through the ``_shard_call`` seam; a node that
        turns out to be unreachable cannot donate its keys and is dropped
        crash-style (its replicas still hold their copies)."""
        with self._lock:
            if name not in self.shards:
                return
            shard = self.shards[name]
            try:
                pairs = self._shard_call(name, "drain_scan", shard.snapshot_items)
            except ShardUnavailable:
                pairs = None  # unreachable: crash-style removal
            self.shards.pop(name)
            self.ring.remove(name)
            self.down.discard(name)
            for k, v in pairs or ():
                self._insert_unlocked(k, v)

    def mark_down(self, name: str) -> None:
        """Crash failure: the node is unreachable, its data NOT migrated
        (replicas serve)."""
        with self._lock:
            self.down.add(name)

    def mark_up(self, name: str) -> None:
        with self._lock:
            self.down.discard(name)

    def restart_node(self, name: str, *, recover: bool = True) -> int:
        """Crash recovery: the node's process restarts empty and rejoins. The
        shard is replaced by a fresh one (the old one, its index and its
        device bank are dropped and freed; its registry series are zeroed,
        as ``clear()`` zeroes them). With ``recover=True`` it read-repairs
        the keys it owns from its peers before serving. Repair reads and
        the repair write go through the ``_shard_call`` seam: an unreachable
        peer cannot donate. Returns the number of repaired entries."""
        with self._lock:
            if name not in self.shards:
                self.add_node(name)
                return 0
            old = self.shards[name]
            if old.cold is not None:
                old.cold.clear()  # a crash loses the manifest; gc reclaims
            self.shards[name] = shard = self._new_shard(name)
            shard.stats.reset()
            self.down.discard(name)
            if not recover:
                return 0
            repaired: List[Tuple[str, Any]] = []
            seen: set = set()
            for peer in sorted(self.shards):
                if peer == name or peer in self.down:
                    continue
                other = self.shards[peer]
                try:
                    # a one-lock scan with peek semantics: repair must not
                    # perturb the peer's recency/frequency state
                    pairs = self._shard_call(peer, "repair_scan", other.snapshot_items)
                except ShardUnavailable:
                    continue
                for k, v in pairs:
                    if k in seen:
                        continue
                    if name in self.ring.nodes_for(k, self.replication):
                        repaired.append((k, v))
                        seen.add(k)
            if repaired:
                try:
                    # fuzzy shards re-embed the repaired keys here: peers do
                    # not expose their index vectors
                    self._shard_call(name, "insert_batch",
                                     lambda: shard.insert_batch(repaired))
                except ShardUnavailable:
                    return 0  # the restarted node died again mid-repair
            return len(repaired)

    def _rebalance(self) -> None:
        """After a ring change, re-home keys whose owner set moved. Every
        shard is scanned through the ``_shard_call`` seam with ``peek``
        semantics; an unreachable shard keeps its keys where they are."""
        moves = []
        for node in list(self.shards):
            shard = self.shards[node]
            try:
                pairs = self._shard_call(node, "rebalance_scan", shard.snapshot_items)
            except ShardUnavailable:
                continue
            for k, v in pairs:
                if node not in self.ring.nodes_for(k, self.replication):
                    moves.append((node, k, v))
        for node, k, v in moves:
            # remove from the stale owner (keeping its index in sync) and
            # reinsert at the right owners; the re-home happens even when
            # the retire call fails (the value is in hand)
            try:
                self._shard_call(node, "remove", lambda s=self.shards[node], k=k: s.remove(k))
            except ShardUnavailable:
                pass
            self._insert_unlocked(k, v)

    # -- cache ops --------------------------------------------------------

    def _shard_call(self, node: str, op: str, fn: Callable[[], Any]) -> Any:
        """Every per-shard call funnels through here: the seam where a
        networked deployment dispatches an RPC and an interceptor may raise
        :class:`ShardUnavailable`, and where tracing wraps all data- and
        control-plane shard traffic in one ``dcache.shard_call`` span."""
        with trace_span(SPAN_SHARD_CALL, node=node, op=op):
            if self.interceptor is not None:
                return self.interceptor.call(node, op, fn)
            return fn()

    def _live(self, names: List[str]) -> List[str]:
        return [n for n in names if n not in self.down and n in self.shards]

    def _probe_order(self, keyword: str) -> List[str]:
        """Ring owners first; with fuzzy shards, scatter to the remaining
        live nodes — a similar key hashes to *its own* owners, not the
        query's, so fuzzy resolution must reach every shard's index (each
        shard still scans only its local keys; in a networked deployment
        this fan-out runs in parallel)."""
        owners = self._live(self.ring.nodes_for(keyword, self.replication))
        if self.fuzzy:
            owners += [
                n for n in sorted(self.shards)
                if n not in self.down and n not in owners
            ]
        return owners

    def lookup_batch(
        self,
        keywords: Sequence[str],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
    ) -> List[Optional[Any]]:
        """Batched lookups under one lock acquisition (router admission).

        Tier-by-tier grouped fan-out: tier 0 groups keywords by primary
        owner so each shard's fuzzy index answers its group in one batched
        call (on the ``device`` backend, one resident-bank device call per
        shard); every subsequent replica/fuzzy-scatter tier batches the
        *still-missing* keywords the same way, so the fallthrough path is
        also O(tiers) shard calls instead of one per keyword. Probe order
        per keyword is identical to the singular ``lookup`` (which IS this
        path with a batch of one), and ``contexts`` ride along to each
        shard's match pipeline.

        Crash fallthrough: a shard call that raises
        :class:`ShardUnavailable` leaves its keywords pending — they retry
        on the next replica tier as if the shard had answered "miss", so a
        crashed but not yet marked-down node costs one wasted probe, never
        a lost entry.
        """
        if contexts is None:
            contexts = [None] * len(keywords)
        with trace_span(SPAN_DCACHE_LOOKUP, n=len(keywords)) as lsp, \
                self._lock:
            out: List[Optional[Any]] = [None] * len(keywords)
            owners_of = [self._probe_order(k) for k in keywords]
            pending = list(range(len(keywords)))
            tier = 0
            while pending:
                by_node: Dict[str, List[int]] = {}
                for i in pending:
                    if tier < len(owners_of[i]):
                        by_node.setdefault(owners_of[i][tier], []).append(i)
                if not by_node:
                    break
                with trace_span(SPAN_DCACHE_TIER, tier=tier,
                                pending=len(pending),
                                shards=len(by_node)):
                    for node, idxs in sorted(by_node.items()):
                        shard = self.shards[node]
                        kws = [keywords[i] for i in idxs]
                        ctxs = [contexts[i] for i in idxs]
                        try:
                            # a nested collector shadows the router's for
                            # exactly this shard call; resolved indices are
                            # re-deposited at the facade's batch positions
                            # with the answering node and replica tier
                            with collect() as shard_attrib:
                                vals = self._shard_call(
                                    node, "lookup_batch",
                                    lambda s=shard, k=kws, c=ctxs:
                                        s.lookup_batch(k, contexts=c),
                                )
                        except ShardUnavailable:
                            continue  # the keywords stay pending: next tier
                        for j, (i, v) in enumerate(zip(idxs, vals)):
                            out[i] = v
                            if v is not None:
                                deposit(i, node=node, replica_tier=tier,
                                        **shard_attrib.get(j))
                pending = [
                    i for i in pending
                    if out[i] is None and tier + 1 < len(owners_of[i])
                ]
                tier += 1
            hits = sum(1 for v in out if v is not None)
            for v in out:
                if v is None:
                    self.stats.misses += 1
                else:
                    self.stats.hits += 1
            lsp.set(hits=hits, tiers=tier)
            return out

    def _insert_unlocked(
        self,
        keyword: str,
        value: Any,
        context: Optional[str] = None,
        vector: Optional[Any] = None,
    ) -> None:
        # control-plane re-homing only (_rebalance / remove_node): membership
        # moves are synchronous; the client write path is insert_batch
        owners = self._live(self.ring.nodes_for(keyword, self.replication))
        if self.fuzzy and vector is None and owners:
            vector = embed(keyword)  # embed once, ship to every replica
        for n in owners:
            shard = self.shards[n]
            try:
                self._shard_call(
                    n, "insert",
                    lambda s=shard: s.insert(
                        keyword, value, context=context, vector=vector
                    ),
                )
            except ShardUnavailable:
                continue  # write lands on the remaining owners

    def now(self) -> float:
        """The facade's clock (shared with every shard) — capture before a
        read whose derived wave inserts with ``unless_written_since``."""
        return self.clock()

    def arm_cold_crash(self, waves: int) -> None:
        """Fault seam: arm every shard's cold tier to crash between segment
        write and manifest commit on its next ``waves`` spill waves (no-op
        for shards without a cold tier)."""
        with self._lock:
            for shard in self.shards.values():
                if shard.cold is not None:
                    shard.cold.arm_crash_after_segment(waves)

    def insert_batch(
        self,
        items: Sequence[Tuple[str, Any]],
        *,
        contexts: Optional[Sequence[Optional[str]]] = None,
        vectors: Optional[Any] = None,
        unless_written_since: Optional[float] = None,
    ) -> None:
        """Admission-wave insert: group by owner shard so each shard takes
        the wave in one ``insert_batch`` call (one device scatter per shard
        on the ``device`` backend). With fuzzy shards the wave is embedded
        ONCE here and the (key, vector) pairs are replicated, so an R-way
        replicated key never embeds R times.

        Synchronous replica acks (``ack_policy="all"``): every live owner
        applies the wave before this call returns, so a reader falling
        through to any replica observes the acked version. A replica that
        raises :class:`ShardUnavailable` is skipped (the wave lands on the
        remaining owners)."""
        items = list(items)
        if contexts is None:
            contexts = [None] * len(items)
        with trace_span(SPAN_DCACHE_INSERT, n=len(items)), self._lock:
            if self.fuzzy and vectors is None and items:
                vectors = embed_batch([kw for kw, _ in items])
            primary_by_node: Dict[str, List[int]] = {}
            replica_by_node: Dict[str, List[int]] = {}
            for j, (kw, _) in enumerate(items):
                owners = self._live(self.ring.nodes_for(kw, self.replication))
                for rank, n in enumerate(owners):
                    tgt = primary_by_node if rank == 0 else replica_by_node
                    tgt.setdefault(n, []).append(j)

            def apply(node: str, idxs: List[int]) -> None:
                shard = self.shards[node]
                shard.insert_batch(
                    [items[j] for j in idxs],
                    contexts=[contexts[j] for j in idxs],
                    vectors=None if vectors is None else [vectors[j] for j in idxs],
                    # conditional admission is enforced per shard: each
                    # shard compares the token against ITS entry timestamps
                    # (all shards share the facade's clock)
                    unless_written_since=unless_written_since,
                )

            for n, idxs in primary_by_node.items():
                try:
                    self._shard_call(n, "insert_batch",
                                     lambda n=n, idxs=idxs: apply(n, idxs))
                except ShardUnavailable:
                    continue  # replicas still take the wave below
            for n, idxs in replica_by_node.items():
                try:
                    self._shard_call(n, "insert_batch",
                                     lambda n=n, idxs=idxs: apply(n, idxs))
                except ShardUnavailable:
                    continue
            self.stats.inserts += len(items)

    def remove(self, keyword: str) -> bool:
        """Delete from every shard holding the key (owners may be stale
        after membership churn). True if any replica held it. A shard that
        is unreachable keeps its stale copy until its next restart wipes
        it — the same tombstone-free semantics a networked delete has."""
        with self._lock:
            removed = False
            for name in sorted(self.shards):
                shard = self.shards[name]
                try:
                    r = self._shard_call(
                        name, "remove", lambda s=shard: s.remove(keyword)
                    )
                except ShardUnavailable:
                    continue
                removed = r or removed
            return removed

    def clear(self) -> None:
        """Wipe every *reachable* shard. Clears go through the interceptor
        seam like any other shard call: an unreachable node keeps its stale
        data until its next restart wipes it (the same tombstone-free
        semantics ``remove`` has)."""
        with self._lock:
            for name in list(self.shards):
                shard = self.shards[name]
                try:
                    self._shard_call(name, "clear", shard.clear)
                except ShardUnavailable:
                    continue
            # reset the shared-registry view in place (see PlanCache.clear)
            self.stats.reset()

    def autotune(self, **thresholds) -> List[str]:
        """Run one index auto-tune step on every reachable shard (see
        PlanCache). Per-shard calls pay the interceptor seam; an
        unreachable shard simply skips this tuning round."""
        with self._lock:
            actions: List[str] = []
            for name, shard in sorted(self.shards.items()):
                try:
                    acts = self._shard_call(
                        name, "autotune",
                        lambda s=shard: s.autotune(**thresholds),
                    )
                except ShardUnavailable:
                    continue
                for act in acts:
                    actions.append(f"{name}/{act}")
            return actions

    def __contains__(self, keyword: str) -> bool:
        # exact membership, no fuzzy resolution and no stats mutation
        # (mirrors PlanCache.__contains__)
        with self._lock:
            owners = self._live(self.ring.nodes_for(keyword, self.replication))
            return any(keyword in self.shards[n] for n in owners)

    def __len__(self) -> int:
        """Distinct reachable keys; pays one seam call per live shard."""
        return len(self.keys())

    def keys(self) -> List[str]:
        """Union of every reachable shard's live keys. The per-shard
        enumeration goes through the interceptor seam — a crashed-but-not-
        marked-down shard contributes nothing (its keys are unreachable,
        exactly what a networked key scan would observe)."""
        with self._lock:
            seen = set()
            for n in list(self.shards):
                if n in self.down:
                    continue
                shard = self.shards[n]
                try:
                    ks = self._shard_call(n, "keys", shard.keys)
                except ShardUnavailable:
                    continue
                seen.update(ks)
            return sorted(seen)

    def load_by_node(self) -> Dict[str, int]:
        return {n: len(s) for n, s in sorted(self.shards.items())}
