"""Sequential model-store oracle and invariant checks (the twin of
``repro.sim.oracle``).

The model is the FoundationDB-style "obviously correct" twin: plain dicts
and lists, single-threaded, no locks, no batching. The step scheduler
serializes every operation, so the linearization order is known; the
optimized store must agree with the model applied in that order.

With ``fuzzy=True`` the model is *similarity-aware*: each node carries a
twin ``repro_torch.index.SimilarityIndex`` over its local keys (the same
hashed-ngram ``embed`` the real shards use), on the same backend and
device as the shards, mirrored call-for-call, so the model predicts
exactly which stored key a
paraphrase lookup resolves to. Paraphrase scenarios are therefore STRICT:
a fuzzy miss the model would have resolved is a durability violation and a
fuzzy hit the model says cannot happen is a phantom, where the pre-churn
model could only integrity-check them.

Membership is mirrored too: ``join`` replays ``add_node`` + ``_rebalance``
(ring change, per-shard scan skipping unreachable nodes, stale-owner
removal, re-home with per-node eviction) and ``drain`` replays the
graceful ``remove_node`` re-home — so elastic churn keeps the model exact.

Checked invariants (consumed by ``repro_torch.sim.harness``):

* **durability / linearizability** — a key the model says is resolvable
  (inserted, acked, replicated, not evicted/removed) must come back, at
  the acked version;
* **resolution / phantom** — a lookup must resolve to exactly the key the
  model resolves it to (exact or fuzzy); a key the model says is absent
  must miss;
* **no torn entries** — every returned value's embedded checksum must
  verify (a torn/partially-applied write cannot masquerade as a hit);
* **stats conservation** — ``hits + misses == lookups`` and
  ``inserts == items offered`` on the facade's own counters;
* **capacity / eviction order** — no shard exceeds capacity, and the
  model replays the eviction policy (LRU / cost) so a wrong victim shows
  up as durability (evicted survivor) or phantom (surviving victim);
* **control plane** — ``keys()``/``len()`` must equal the union of the
  model's reachable nodes.

Intra-wave recency is mirrored faithfully: ``lookup_wave`` replays the
facade's tier-major grouped fan-out (tier 0 groups queries by primary
owner; each later tier re-groups the still-missing ones; shard groups
visit in sorted-node order) and, within one shard call, the match
pipeline's stage order — the whole group's exact stage first, then ONE
batched similarity call for the leftovers, then per-key cold promotion —
so per-shard per-tier LRU touch order inside a single wave matches the
store bit-for-bit and the eviction-order oracle runs on fuzzy cells too.
Router-driven cells stay outside that oracle's gate for a different
reason: route lookups touch store recency through traffic the admission
mirror never sees (see the harness's gating).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.distributed_cache import HashRing


@dataclass
class Violation:
    step: int
    oracle: str  # "durability" | "linearizability" | "phantom" | ...
    detail: str


def checksum(kw: str, version: int) -> str:
    return hashlib.blake2b(f"{kw}#{version}".encode(), digest_size=8).hexdigest()


def make_value(kw: str, version: int) -> Dict[str, Any]:
    """A sim cache value carrying its own integrity proof."""
    return {"k": kw, "v": version, "ck": checksum(kw, version)}


def value_torn(value: Any) -> bool:
    """True when a returned value fails its integrity check."""
    if not isinstance(value, dict) or "ck" not in value:
        return True
    return value.get("ck") != checksum(value.get("k", ""), value.get("v", -1))


class ModelStore:
    """Sequential mirror of DistributedPlanCache's documented semantics."""

    def __init__(
        self,
        *,
        replication: int = 2,
        capacity_per_node: int = 256,
        eviction: str = "lru",
        vnodes: int = 64,
        exact_only: bool = True,
        fuzzy: bool = False,
        fuzzy_threshold: float = 0.8,
        index_backend: str = "auto",
        device=None,
        clock: Optional[Any] = None,
        ttl_s: Optional[float] = None,
        cold_enabled: bool = False,
    ):
        if eviction not in ("lru", "cost"):
            raise ValueError("model replays eviction for 'lru' and 'cost' only")
        self.replication = replication
        self.capacity = capacity_per_node
        self.eviction = eviction
        self.exact_only = exact_only
        self.fuzzy = fuzzy
        self.fuzzy_threshold = fuzzy_threshold
        self.index_backend = index_backend
        self.device = device
        # TTL twin: entries expire strictly after ttl_s, judged against the
        # SAME virtual clock the store reads. The scheduler serializes ops
        # and nothing advances the clock between a store op and its mirror
        # call here, so write stamps and expiry decisions agree bit-for-bit
        # (the single-node pinning in SimConfig.normalized keeps one seam
        # charge per op).
        self.clock = clock
        self.ttl_s = ttl_s
        # cold-tier twin (memory/tiered.py): per-node manifest mirror;
        # eviction spills, exact-miss promotes (a MOVE back to hot with a
        # cascading evict), expiry/remove never resurrect from cold
        self.cold_enabled = cold_enabled
        self.ring = HashRing(vnodes)
        self.nodes: Dict[str, Dict[str, Any]] = {}
        self.hits: Dict[str, Dict[str, int]] = {}
        self.order: Dict[str, List[str]] = {}  # LRU recency, oldest first
        self.seq: Dict[str, Dict[str, int]] = {}  # stable dict-order mirror
        self.sim: Dict[str, Any] = {}  # per-node SimilarityIndex twins
        self.wtime: Dict[str, Dict[str, float]] = {}  # write stamps (TTL/CAS)
        self.cold: Dict[str, Dict[str, Any]] = {}  # cold-manifest mirrors
        self._next_seq = 0
        self._cold_crash = 0  # armed spill-wave crashes (segment w/o manifest)
        self.crashed: set = set()
        self.evictions = 0

    def _now(self) -> float:
        return float(self.clock()) if self.clock is not None else 0.0

    def _expired(self, node: str, kw: str) -> bool:
        if self.ttl_s is None:
            return False
        return self._now() - self.wtime[node][kw] > self.ttl_s

    def arm_cold_crash(self, waves: int) -> None:
        """Mirror of ``DistributedPlanCache.arm_cold_crash``: the next
        ``waves`` spill waves lose their entries (segment written, manifest
        never committed)."""
        self._cold_crash = waves

    # -- membership ----------------------------------------------------------

    def add_node(self, name: str) -> None:
        if name in self.nodes:
            return
        self.nodes[name] = {}
        self.hits[name] = {}
        self.order[name] = []
        self.seq[name] = {}
        self.wtime[name] = {}
        self.cold[name] = {}
        if self.fuzzy:
            from repro_torch.index import SimilarityIndex

            # the twin index: same backend and device, mirrored
            # call-for-call, so scores/slots/tie-breaks are bit-identical
            # to the shard's
            self.sim[name] = SimilarityIndex(backend=self.index_backend, device=self.device)
        self.ring.add(name)

    def join(self, name: str) -> None:
        """Mirror of ``add_node`` on a live cluster: ring change + the
        ``_rebalance`` re-home (the churn-rehoming guard's CORRECT
        semantics — an ablated store diverges from this and the durability
        oracle catches it)."""
        if name in self.nodes:
            return
        self.add_node(name)
        self._rebalance()

    def drain(self, name: str) -> None:
        """Mirror of graceful ``remove_node``: the drain scan re-homes the
        node's keys to their new owners — unless the node is unreachable,
        in which case its copies are lost with it (crash-style removal)."""
        if name not in self.nodes:
            return
        pairs = (
            [] if name in self.crashed else list(self.nodes[name].items())
        )
        self._drop_node(name)
        for kw, v in pairs:
            self._insert_single(kw, v)

    def _drop_node(self, name: str) -> None:
        del self.nodes[name]
        del self.hits[name]
        del self.order[name]
        del self.seq[name]
        self.wtime.pop(name, None)
        # a dropped node takes its cold directory with it — nothing re-homes
        self.cold.pop(name, None)
        self.sim.pop(name, None)
        self.ring.remove(name)
        self.crashed.discard(name)

    def _rebalance(self) -> None:
        """Mirror of ``DistributedPlanCache._rebalance``: scan shards in
        membership order (an unreachable shard keeps its keys), collect
        keys whose owner set no longer includes their holder, then remove
        from the stale owner and re-home with per-node eviction."""
        moves: List[Tuple[str, str, Any]] = []
        for node in list(self.nodes):
            if node in self.crashed:
                continue  # scan RPC fails: its keys stay put
            for kw, v in list(self.nodes[node].items()):
                if node not in self.ring.nodes_for(kw, self.replication):
                    moves.append((node, kw, v))
        for node, kw, v in moves:
            self._remove_from(node, kw)
            # the facade re-homes via ``shard.remove`` which purges the
            # stale owner's cold manifest too
            if self.cold_enabled:
                self.cold[node].pop(kw, None)
            self._insert_single(kw, v)

    def crash(self, name: str) -> None:
        self.crashed.add(name)

    def restore(self, name: str) -> None:
        self.crashed.discard(name)

    def restart(self, name: str, *, recover: bool = True) -> None:
        """Mirror of ``restart_node``: data gone; read-repair from peers."""
        self.crashed.discard(name)
        self.nodes[name] = {}
        self.hits[name] = {}
        self.order[name] = []
        self.seq[name] = {}
        # restart_node calls shard.clear(), which wipes the cold manifest
        # and gc's its segments — cold entries do NOT survive a restart
        self.wtime[name] = {}
        self.cold[name] = {}
        if self.fuzzy:
            self.sim[name].clear()
        if not recover:
            return
        for peer in sorted(self.nodes):
            # an unreachable peer cannot donate repair data (the facade's
            # repair scan goes through the interceptor seam and fails)
            if peer == name or peer in self.crashed:
                continue
            for kw, v in self.nodes[peer].items():
                if kw in self.nodes[name]:
                    continue
                if name in self.ring.nodes_for(kw, self.replication):
                    self._apply(name, kw, v)
        if self.fuzzy and self.nodes[name]:
            # the repaired entries land as ONE insert_batch on the real
            # restarted shard, so the twin ingests them as one batch too
            self.sim[name].add_batch(list(self.nodes[name]))
        self._evict(name)

    # -- write path ----------------------------------------------------------

    def _apply(self, node: str, kw: str, value: Any) -> None:
        store = self.nodes[node]
        if kw not in self.seq[node]:
            self._next_seq += 1
            self.seq[node][kw] = self._next_seq
        store[kw] = value
        self.wtime[node][kw] = self._now()
        self.hits[node][kw] = 0  # re-insert resets live-hit accounting
        if kw in self.order[node]:
            self.order[node].remove(kw)
        self.order[node].append(kw)

    def _remove_from(self, node: str, kw: str) -> None:
        del self.nodes[node][kw]
        del self.hits[node][kw]
        self.wtime[node].pop(kw, None)
        self.order[node].remove(kw)
        # dict-order fidelity: a removed key re-inserts at the END of the
        # real shard's store dict, so its order stamp must not survive
        self.seq[node].pop(kw, None)
        if self.fuzzy:
            self.sim[node].remove(kw)

    def _victim(self, node: str) -> str:
        if self.eviction == "lru":
            return self.order[node][0]
        # cost: min (1 + hits) * tokens_saved(=1 for dict values), ties by
        # dict order (mirrors CacheEntry.inserted_at ties within a wave)
        return min(
            self.nodes[node],
            key=lambda k: (1 + self.hits[node][k], self.seq[node][k]),
        )

    def _evict(self, node: str) -> None:
        victims: List[Tuple[str, Any]] = []
        while len(self.nodes[node]) > self.capacity:
            victim = self._victim(node)
            victims.append((victim, self.nodes[node][victim]))
            self._remove_from(node, victim)
            self.evictions += 1
        if victims and self.cold_enabled:
            # capacity victims SPILL (expiry/remove never do); one spill
            # wave per eviction round, lost whole if a crash is armed
            # between segment write and manifest commit
            if self._cold_crash > 0:
                self._cold_crash -= 1
            else:
                for kw, v in victims:
                    self.cold[node][kw] = v

    def _live_owners(self, kw: str) -> List[str]:
        return [
            n for n in self.ring.nodes_for(kw, self.replication)
            if n in self.nodes
        ]

    def _insert_single(self, kw: str, value: Any) -> None:
        """Mirror of ``_insert_unlocked`` (the membership re-home path):
        one key to every reachable owner, evicting after each owner's
        single-item wave."""
        for n in self._live_owners(kw):
            if n in self.crashed:
                continue  # write RPC failed; remaining owners hold it
            self._apply(n, kw, value)
            if self.fuzzy:
                self.sim[n].add(kw)
            self._evict(n)

    def insert_wave(
        self,
        items: Sequence[Tuple[str, Any]],
        *,
        unless_written_since: Optional[float] = None,
    ) -> None:
        """Spec semantics: the wave lands on every live owner (crashed
        owners drop their copy — the RPC fails), grouped per node with
        eviction AFTER each node's sub-wave (primary groups first, then
        replica groups, mirroring the facade's ack structure).

        ``unless_written_since`` mirrors conditional admission: a key whose
        live entry on that node was (re)written at or after the token is
        skipped — the stale background wave loses to the newer client
        insert, per node, exactly as each shard decides it."""
        for rank0 in (True, False):
            groups: Dict[str, List[Tuple[str, Any]]] = {}
            for kw, v in items:
                owners = self._live_owners(kw)
                for rank, n in enumerate(owners):
                    if (rank == 0) == rank0:
                        groups.setdefault(n, []).append((kw, v))
            for n, sub in groups.items():
                if n in self.crashed:
                    continue  # write RPC failed; remaining owners hold it
                applied: List[str] = []
                for kw, v in sub:
                    if (
                        unless_written_since is not None
                        and kw in self.nodes[n]
                        and self.wtime[n][kw] >= unless_written_since
                    ):
                        continue  # stale write skipped; index untouched
                    self._apply(n, kw, v)
                    applied.append(kw)
                if self.fuzzy and applied:
                    self.sim[n].add_batch(applied)
                self._evict(n)

    def remove(self, kw: str) -> None:
        for n in sorted(self.nodes):
            if n in self.crashed:
                continue  # unreachable; its stale copy dies at restart
            if kw in self.nodes[n]:
                self._remove_from(n, kw)
            if self.cold_enabled:
                # shard.remove purges the cold manifest entry too — a
                # removed key must not resurrect through a later promote
                self.cold[n].pop(kw, None)

    # -- read path -----------------------------------------------------------

    def _probe_order(self, kw: str) -> List[str]:
        owners = [n for n in self._live_owners(kw)]
        if self.fuzzy:
            owners += [n for n in sorted(self.nodes) if n not in owners]
        return owners

    def _touch(self, node: str, kw: str) -> Any:
        """Serve one live key on one node: hit counter + LRU move-to-end
        (the accounting half of ``_get_live`` after its expiry check)."""
        self.hits[node][kw] += 1
        if kw in self.order[node]:
            self.order[node].remove(kw)
            self.order[node].append(kw)
        return self.nodes[node][kw]

    def _get_live(self, node: str, kw: str) -> Optional[Any]:
        """Mirror of ``PlanCache._get_live``: TTL expire-on-touch is a
        hard delete (the entry does NOT spill), a survivor is touched. A
        key an earlier serve of the SAME stage already expired misses
        here — the pipeline resolves the whole group before serving."""
        if kw not in self.nodes[node]:
            return None
        if self._expired(node, kw):
            self._remove_from(node, kw)
            return None
        return self._touch(node, kw)

    def _promote_cold(self, node: str, kw: str) -> Optional[Any]:
        """Mirror of ``PlanCache._promote``: a cold manifest hit is a
        MOVE back through the admission path, cascading evict after the
        insert, then served through the normal touch path."""
        v = self.cold[node].pop(kw)
        self._apply(node, kw, v)
        if self.fuzzy:
            self.sim[node].add_batch([kw])
        self._evict(node)
        # under the cost policy a promote into a fully-reused hot set
        # picks ITSELF as the cascade victim (hits=0, youngest stamp)
        # — the store then misses, so the model must too
        if kw not in self.nodes[node]:
            return None
        return self._touch(node, kw)

    def _serve_group(
        self,
        node: str,
        group: List[Tuple[int, str]],
        out: List[Optional[Any]],
    ) -> None:
        """Mirror ONE shard ``lookup_batch`` call for its tier group.

        Stage-major, exactly like the shard's match pipeline: the exact
        stage resolves the WHOLE group (membership snapshot first, then
        serves in group order — so a twin query whose key expired under
        an earlier serve of the same stage stays pending); the fuzzy
        stage answers the leftovers with ONE batched similarity call
        against the twin index; the cold stage promotes per still-
        pending key in group order. This is what makes per-shard LRU
        touch order inside a single wave bit-identical to the store."""
        # exact stage: resolve all, then serve in group order
        alts = [kw if kw in self.nodes[node] else None for _, kw in group]
        pending: List[Tuple[int, str]] = []
        for (i, kw), alt in zip(group, alts):
            v = None if alt is None else self._get_live(node, alt)
            if v is None:
                pending.append((i, kw))
            else:
                out[i] = v
        # fuzzy stage: one batched index call for the still-unresolved
        if pending and self.fuzzy:
            alts = self.sim[node].best_match_batch(
                [kw for _, kw in pending], self.fuzzy_threshold
            )
            still: List[Tuple[int, str]] = []
            for (i, kw), alt in zip(pending, alts):
                # an expired fuzzy twin dies inside _get_live and the
                # wave does NOT re-run the stage — the query falls
                # through to the cold stage / next tier
                v = None if alt is None else self._get_live(node, alt)
                if v is None:
                    still.append((i, kw))
                else:
                    out[i] = v
            pending = still
        # cold stage: shard-local manifest, exact keys, group order
        if pending and self.cold_enabled:
            for i, kw in pending:
                if kw in self.cold.get(node, {}):
                    out[i] = self._promote_cold(node, kw)

    def lookup_wave(
        self, kws: Sequence[str]
    ) -> List[Tuple[Optional[Any], bool]]:
        """Tier-major grouped replay of one batched facade lookup.

        Mirrors ``DistributedPlanCache.lookup_batch`` shape-for-shape:
        tier 0 groups queries by primary owner, every later tier
        re-groups the still-missing ones, shard groups are visited in
        sorted-node order, and each (node, group) runs the full match
        pipeline via ``_serve_group``. A crashed node's seam call fails,
        so its group stays pending and retries on the next replica tier
        — the crash-fallthrough guard's correct semantics."""
        strict = True if self.fuzzy else self.exact_only
        out: List[Optional[Any]] = [None] * len(kws)
        owners_of = [self._probe_order(kw) for kw in kws]
        pending = list(range(len(kws)))
        tier = 0
        while pending:
            by_node: Dict[str, List[int]] = {}
            for i in pending:
                if tier < len(owners_of[i]):
                    by_node.setdefault(owners_of[i][tier], []).append(i)
            if not by_node:
                break
            for node, idxs in sorted(by_node.items()):
                if node in self.crashed:
                    continue  # seam call fails; queries retry next tier
                self._serve_group(node, [(i, kws[i]) for i in idxs], out)
            pending = [
                i for i in pending
                if out[i] is None and tier + 1 < len(owners_of[i])
            ]
            tier += 1
        return [
            (v, True) if v is not None else (None, strict) for v in out
        ]

    def lookup(self, kw: str) -> Tuple[Optional[Any], bool]:
        """(expected value or None, strict).

        Walks the same tiered probe order as the facade — ring owners,
        then (fuzzy) the remaining shards — resolving per node exactly as
        the shard's match pipeline does: exact dict membership first, then
        the twin similarity index at the shard's threshold, then the cold
        manifest. With the twin index mirrored call-for-call the
        prediction is exact, so fuzzy cells are STRICT; ``strict=False``
        survives only for the legacy ``exact_only=False`` mode (no
        similarity model installed)."""
        return self.lookup_wave([kw])[0]

    def keys(self) -> List[str]:
        seen: set = set()
        for store in self.nodes.values():
            seen.update(store)
        return sorted(seen)

    def visible_keys(self) -> List[str]:
        """What a control-plane ``keys()`` scan can observe right now:
        the union of every *reachable* node's keys (a crashed node's seam
        call fails, so its keys are invisible until it restarts)."""
        seen: set = set()
        for n, store in self.nodes.items():
            if n not in self.crashed:
                seen.update(store)
        return sorted(seen)


__all__ = ["ModelStore", "Violation", "checksum", "make_value", "value_torn"]
