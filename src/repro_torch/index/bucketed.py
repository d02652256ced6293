"""Signed-random-projection LSH over an EmbeddingBank: sublinear candidates
(the twin of ``repro.index.bucketed``, on the host in numpy).

Each row is hashed into ``n_tables`` independent ``n_bits``-bit signatures
(sign patterns of projections onto fixed random hyperplanes); a query scans
only the buckets within Hamming distance ``probe_hamming`` of its signature
in each table (multi-probe, multi-table) and reranks those candidates
exactly. By default ``n_bits`` adapts (grows with the bank, ~log2(N)) so a
lookup's cost stays roughly flat as N grows.

Below ``scan_threshold`` live entries the index answers with the exact brute
scan: at small N the full matmul is both faster and recall-perfect.

The hyperplanes are drawn exactly as the reference draws them
(``np.random.RandomState(seed + n_bits)``), so both packages give the same
candidate sets.

Thread-safety: no lock of its own. Mutation (``on_add`` / ``on_remove`` /
``clear``) and ``autotune`` run under the owning bank's lock
(``SimilarityIndex`` does this); queries are unlocked reads.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.index.bank import DIM, EmbeddingBank

NEG_INF = np.float32(-1e30)
# per-query candidate-count histogram bounds 1, 2, 4, ... 2^31 (the
# reference's pow2_buckets(32)); an overflow bucket sits past the last
_CANDIDATE_BOUNDS = tuple(float(1 << i) for i in range(32))


class LSHTelemetry:
    """Live quality/cost counters for one BucketedIndex, with the
    reference's field names and ``snapshot()``: plain counters written by
    the index (a metrics registry behind them is not ported).

    Rising ``avg_candidates`` means the tables are under-sized (grow
    ``n_bits``); a falling ``top1_agreement`` or rising
    ``empty_candidate_rate`` means probes miss too often (grow
    ``probe_hamming``). Recall is measured live by re-answering every
    ``recall_sample_every``-th probed query with the exact scan.
    """

    _FIELDS = ("queries", "brute_fallback_queries", "probed_queries",
               "candidates_total", "empty_candidate_queries", "recall_checks",
               "recall_agreements")

    def __init__(self) -> None:
        self.reset()

    def observe_brute(self) -> None:
        self.queries += 1
        self.brute_fallback_queries += 1

    def observe_probe(self, n_candidates: int) -> None:
        self.queries += 1
        self.probed_queries += 1
        self.candidates_total += n_candidates
        if n_candidates == 0:
            self.empty_candidate_queries += 1
        # bucket b counts queries that scanned (2^(b-1), 2^b] candidates
        self._candidate_hist[bisect.bisect_left(_CANDIDATE_BOUNDS, n_candidates)] += 1

    def observe_recall(self, agreed: bool) -> None:
        self.recall_checks += 1
        self.recall_agreements += int(agreed)

    def reset(self) -> None:
        """A fresh telemetry window (autotune calls this after acting)."""
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._candidate_hist = [0] * (len(_CANDIDATE_BOUNDS) + 1)

    def snapshot(self) -> Dict[str, Any]:
        probed = max(1, self.probed_queries)
        return {
            "queries": self.queries,
            "probed_queries": self.probed_queries,
            "brute_fallback_queries": self.brute_fallback_queries,
            "avg_candidates": round(self.candidates_total / probed, 2),
            "empty_candidate_rate": round(self.empty_candidate_queries / probed, 4),
            "candidate_hist": {
                f"2^{b}": c
                for b, c in enumerate(self._candidate_hist[: len(_CANDIDATE_BOUNDS)])
                if c
            },
            "top1_agreement": (
                round(self.recall_agreements / self.recall_checks, 4)
                if self.recall_checks
                else None
            ),
            "recall_checks": self.recall_checks,
        }


def _brute_topk(
    matrix: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact numpy top-k over ``matrix`` rows; the shared fallback path."""
    Q = queries.shape[0]
    N = matrix.shape[0]
    scores = np.full((Q, k), NEG_INF, np.float32)
    idx = np.full((Q, k), -1, np.int32)
    if N == 0 or Q == 0:
        return scores, idx
    s = queries.astype(np.float32) @ matrix.T  # (Q, N)
    kk = min(k, N)
    if kk < N:
        part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
    else:
        part = np.broadcast_to(np.arange(N), (Q, N)).copy()
    ps = np.take_along_axis(s, part, axis=1)
    order = np.argsort(-ps, axis=1, kind="stable")
    scores[:, :kk] = np.take_along_axis(ps, order, axis=1)
    idx[:, :kk] = np.take_along_axis(part, order, axis=1).astype(np.int32)
    return scores, idx


class BucketedIndex:
    """Multi-table multi-probe SRP-LSH + exact rerank over a bank."""

    MAX_BITS = 20
    TARGET_OCCUPANCY = 4  # resize when avg live entries per bucket exceeds this

    def __init__(
        self,
        bank: EmbeddingBank,
        *,
        n_tables: int = 4,
        n_bits: Optional[int] = None,
        seed: int = 0,
        probe_hamming: int = 1,
        scan_threshold: int = 2048,
        recall_sample_every: int = 64,
    ):
        """``n_bits=None`` (default) adapts: start at 12 bits and rebuild
        with +2 bits whenever average bucket occupancy exceeds
        ``TARGET_OCCUPANCY``. An explicit ``n_bits`` pins the table size."""
        self._adaptive = n_bits is None
        n_bits = 12 if n_bits is None else n_bits
        if not (1 <= n_bits <= 30 and n_tables >= 1):
            raise ValueError(f"need 1 <= n_bits <= 30 and n_tables >= 1, got "
                             f"{n_bits}, {n_tables}")
        # the probe ball is enumerated up to Hamming distance 2
        if not 0 <= probe_hamming <= 2:
            raise ValueError(f"probe_hamming must be 0, 1 or 2, got {probe_hamming}")
        self.bank = bank
        self.n_tables = n_tables
        self.probe_hamming = probe_hamming
        self.scan_threshold = scan_threshold
        self.telemetry = LSHTelemetry()
        self._recall_every = recall_sample_every
        self._seed = seed
        self._set_geometry(n_bits)
        self._rebuild()  # bootstrap from whatever the bank already holds

    def _set_geometry(self, n_bits: int) -> None:
        self.n_bits = n_bits
        rs = np.random.RandomState(self._seed + n_bits)
        # one (DIM, n_bits) hyperplane block per table, drawn contiguously
        self._planes = rs.randn(DIM, self.n_tables * n_bits).astype(np.float32)
        self._buckets: List[Dict[int, Set[int]]] = [{} for _ in range(self.n_tables)]
        self._sigs_of: Dict[int, Tuple[int, ...]] = {}
        self._bit_weights = (1 << np.arange(n_bits)).astype(np.int64)
        self._set_probe_masks()

    def _set_probe_masks(self) -> None:
        # XOR masks enumerating the probe ball once: [0, single bits, pairs]
        n_bits = self.n_bits
        masks = [0]
        if self.probe_hamming >= 1:
            masks += [1 << b for b in range(n_bits)]
        if self.probe_hamming >= 2:
            masks += [
                (1 << b1) ^ (1 << b2)
                for b1 in range(n_bits)
                for b2 in range(b1 + 1, n_bits)
            ]
        self._probe_masks = np.asarray(masks, np.int64)

    def _rebuild(self) -> None:
        keys = self.bank.keys()
        if not keys:
            return
        slots = [self.bank.slot_of(k) for k in keys]
        sig_mat = self._signatures(self.bank.matrix()[slots])
        for slot, sigs in zip(slots, sig_mat):
            self._insert_sigs(slot, tuple(int(s) for s in sigs))

    def _maybe_grow(self) -> None:
        if (
            self._adaptive
            and self.n_bits < self.MAX_BITS
            and len(self._sigs_of) > self.TARGET_OCCUPANCY << self.n_bits
        ):
            self._set_geometry(min(self.n_bits + 2, self.MAX_BITS))
            self._rebuild()

    # -- maintenance ------------------------------------------------------

    def _signatures(self, vecs: np.ndarray) -> np.ndarray:
        """(M, DIM) -> (M, n_tables) int64 signatures."""
        bits = (np.atleast_2d(vecs) @ self._planes) > 0  # (M, T*b)
        return bits.reshape(-1, self.n_tables, self.n_bits) @ self._bit_weights

    def _insert_sigs(self, slot: int, sigs: Tuple[int, ...]) -> None:
        self._sigs_of[slot] = sigs
        for t, sig in enumerate(sigs):
            self._buckets[t].setdefault(sig, set()).add(slot)

    def on_add(self, slot: int, vec: np.ndarray) -> None:
        self.on_remove(slot)  # slot reuse: drop any stale signature first
        sigs = self._signatures(np.asarray(vec, np.float32))[0]
        self._insert_sigs(slot, tuple(int(s) for s in sigs))
        self._maybe_grow()

    def on_remove(self, slot: int) -> None:
        sigs = self._sigs_of.pop(slot, None)
        if sigs is None:
            return
        for t, sig in enumerate(sigs):
            b = self._buckets[t].get(sig)
            if b is not None:
                b.discard(slot)
                if not b:
                    del self._buckets[t][sig]

    def clear(self) -> None:
        for b in self._buckets:
            b.clear()
        self._sigs_of.clear()

    # -- auto-tuning ------------------------------------------------------

    def autotune(
        self,
        *,
        target_candidates: float = 96.0,
        min_recall: float = 0.92,
        min_queries: int = 64,
    ) -> Optional[str]:
        """One tuning step from the live telemetry window; returns the action
        taken, or None if the window is thin or nothing needs to change.
        Each action resets the window so the next call measures the new
        geometry:

        1. sampled top-1 recall below ``min_recall`` -> ``probe_hamming`` +1;
        2. ``avg_candidates`` above ``target_candidates`` -> ``n_bits`` +2
           (a full re-hash);
        3. more than 10% of probed queries found no candidate ->
           ``probe_hamming`` +1.

        Callers hold ``bank.lock`` (``SimilarityIndex.autotune`` does).
        """
        t = self.telemetry
        if t.probed_queries < min_queries:
            return None
        recall = t.recall_agreements / t.recall_checks if t.recall_checks else None
        avg_candidates = t.candidates_total / t.probed_queries
        empty_rate = t.empty_candidate_queries / t.probed_queries
        action = None
        if recall is not None and recall < min_recall and self.probe_hamming < 2:
            self.probe_hamming += 1
            self._set_probe_masks()
            action = f"probe_hamming->{self.probe_hamming}"
        elif avg_candidates > target_candidates and self.n_bits < self.MAX_BITS:
            self._set_geometry(min(self.n_bits + 2, self.MAX_BITS))
            self._rebuild()
            action = f"n_bits->{self.n_bits}"
        elif empty_rate > 0.10 and self.probe_hamming < 2:
            self.probe_hamming += 1
            self._set_probe_masks()
            action = f"probe_hamming->{self.probe_hamming}"
        if action is not None:
            self.telemetry.reset()
        return action

    # -- search -----------------------------------------------------------

    def _candidates_raw(self, query: np.ndarray) -> np.ndarray:
        """Probed slots, possibly repeated across tables (argmax-safe)."""
        sigs = self._signatures(query)[0]
        out: List[int] = []
        for t in range(self.n_tables):
            get = self._buckets[t].get
            for s in (int(sigs[t]) ^ self._probe_masks).tolist():
                b = get(s)
                if b:
                    out.extend(b)
        return np.asarray(out, np.int64)

    def candidates(self, query: np.ndarray) -> np.ndarray:
        """Slot ids in probed buckets across all tables (sorted, deduped)."""
        raw = self._candidates_raw(np.asarray(query, np.float32))
        return np.unique(raw) if raw.size else raw

    def best_slot(self, query: np.ndarray) -> Tuple[float, int]:
        """Single-query argmax: (score, slot) or (-1e30, -1). Repeated
        candidates are not deduplicated: they cannot change an argmax."""
        M = self.bank.matrix()
        if len(self.bank) <= self.scan_threshold:
            self.telemetry.observe_brute()
            if M.shape[0] == 0:
                return float(NEG_INF), -1
            s = M @ query
            j = int(np.argmax(s))
            return float(s[j]), j
        cand = self._candidates_raw(query)
        self.telemetry.observe_probe(int(cand.size))
        if cand.size == 0:
            return float(NEG_INF), -1
        s = M[cand] @ query
        j = int(np.argmax(s))
        slot = int(cand[j])
        if self._recall_every and self.telemetry.probed_queries % self._recall_every == 0:
            # live recall sample: the exact best score over live slots only
            # (a tombstoned zero row must not win when every live cosine is
            # negative), compared by score so exact ties agree
            live = np.fromiter(self._sigs_of.keys(), np.int64)
            exact_best = float(np.max(M[live] @ query))
            self.telemetry.observe_recall(float(s[j]) >= exact_best - 1e-6)
        return float(s[j]), slot

    def topk(self, queries: np.ndarray, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k) f32, slots (Q, k) i32), -1/-1e30 padded: exact
        within the probed candidates; exact over the whole bank when it
        holds at most ``scan_threshold`` entries."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        M = self.bank.matrix()
        if len(self.bank) <= self.scan_threshold:
            for _ in range(queries.shape[0]):
                self.telemetry.observe_brute()
            return _brute_topk(M, queries, k)
        Q = queries.shape[0]
        scores = np.full((Q, k), NEG_INF, np.float32)
        slots = np.full((Q, k), -1, np.int32)
        for r in range(Q):
            if k == 1:  # the argmax path
                scores[r, 0], slots[r, 0] = self.best_slot(queries[r])
                continue
            cand = self.candidates(queries[r])
            self.telemetry.observe_probe(int(cand.size))
            if cand.size == 0:
                continue
            s, i = _brute_topk(M[cand], queries[r : r + 1], k)
            scores[r] = s[0]
            valid = i[0] >= 0
            slots[r, valid] = cand[i[0][valid]].astype(np.int32)
        return scores, slots


__all__ = ["BucketedIndex", "LSHTelemetry", "NEG_INF"]
