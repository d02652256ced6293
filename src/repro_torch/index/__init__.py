"""repro_torch.index — the similarity index behind the fuzzy and semantic
match stages (the twin of ``repro.index``).

* :class:`~repro_torch.index.bank.EmbeddingBank` — float32 slot arena with a
  freelist (O(1) add/remove) and the batched hashed-ngram embedding.
* ``ops.batch_topk`` / ``ops.resident_topk`` — cosine top-k, one call per
  request batch: the CUDA kernel on the card, the plain version on the CPU.
* :class:`~repro_torch.index.bucketed.BucketedIndex` — multi-probe SRP-LSH
  on the host for sublinear candidates at 1e6 entries.
* :class:`~repro_torch.index.device.DeviceBank` — the arena mirrored on the
  card, written in place, searched with no bank bytes uploaded per lookup.

:class:`SimilarityIndex` is the facade: pick a backend (``auto`` |
``brute`` | ``bucketed`` | ``pallas`` | ``device``) and get
add/remove/topk/best_match over keys. ``brute`` is the exact numpy scan on
the host; ``bucketed`` the LSH index on the host; ``auto`` (the default, as
in the reference) scans exactly while the bank holds at most
``auto_bucketed_min`` live entries and probes the LSH tables beyond.
``pallas`` uploads the host arena to ``device`` on every call and searches
it there; ``device`` keeps a ``DeviceBank`` on ``device`` in lockstep with
the host arena.

Thread-safety: all mutation takes ``self.bank.lock`` and updates the host
arena, the LSH buckets and the device arena together. ``pallas``/``device``
searches run under ``bank.lock``; a host search reads the arena as it is,
and callers that need a consistent view hold the lock (``PlanCache`` wraps
every index call in its own lock).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.index.bank import DIM, EmbeddingBank, embed, embed_batch
from repro_torch.index.bucketed import NEG_INF, BucketedIndex, _brute_topk
from repro_torch.index.device import DeviceBank
from repro_torch.obs import MetricsRegistry, trace_span
from repro_torch.obs.names import SPAN_INDEX_TOPK

BACKENDS = ("auto", "brute", "pallas", "bucketed", "device")


class SimilarityIndex:
    """Key -> embedding store with a pluggable top-k search backend.

    ``device`` is where the ``pallas`` and ``device`` backends search:
    CUDA unless the caller asks for another (the tests pass ``"cpu"``,
    which runs the plain version). ``brute``, ``bucketed`` and ``auto``
    always search on the host and ignore ``device``. ``obs`` is the
    registry where the backend's telemetry (LSH counters, the device bank's
    upload counters) registers, labelled ``obs_labels``; a private one
    otherwise.
    """

    def __init__(
        self,
        *,
        backend: str = "auto",
        initial_capacity: int = 64,
        auto_bucketed_min: int = 4096,
        device=None,
        obs: Optional[MetricsRegistry] = None,
        obs_labels: Optional[Dict[str, str]] = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.backend = backend
        self.bank = EmbeddingBank(initial_capacity)
        self.obs_labels = dict(obs_labels or {})
        self.device: Optional[torch.device] = None
        self._bucketed: Optional[BucketedIndex] = None
        self._device: Optional[DeviceBank] = None
        if backend in ("bucketed", "auto"):
            self._bucketed = BucketedIndex(
                self.bank,
                scan_threshold=auto_bucketed_min if backend == "auto" else 2048,
                obs=obs,
                obs_labels=self.obs_labels,
            )
        if backend in ("pallas", "device"):
            from repro_torch.models.common import resolve_device

            self.device = resolve_device(device)
        if backend == "device":
            self._device = DeviceBank(self.bank.arena().shape[0], device=self.device,
                                      obs=obs, obs_labels=self.obs_labels)

    # -- mutation ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.bank)

    def __contains__(self, key: str) -> bool:
        return key in self.bank

    def add(self, key: str, vector: Optional[np.ndarray] = None) -> int:
        with self.bank.lock:
            slot = self.bank.add(key, vector)
            if self._bucketed is not None:
                self._bucketed.on_add(slot, self.bank.matrix()[slot])
            if self._device is not None:
                self._device.set_row(slot, self.bank.matrix()[slot])
            return slot

    def add_batch(
        self, keys: Sequence[str], vectors: Optional[np.ndarray] = None
    ) -> List[int]:
        """Insert a whole admission wave: one embedding batch and, on the
        ``device`` backend, one multi-slot device write."""
        keys = list(keys)
        if not keys:
            return []
        if vectors is None:
            vectors = embed_batch(keys)
        vectors = np.asarray(vectors, np.float32)
        # dedupe with last-wins (the sequential host semantics): a repeated
        # index in one index_copy_ has no defined winner, which would let
        # the device row diverge from the host arena
        vec_of = {key: vec for key, vec in zip(keys, vectors)}
        with self.bank.lock:
            slot_of = {}
            for key, vec in vec_of.items():
                slot = self.bank.add(key, vec)
                slot_of[key] = slot
                if self._bucketed is not None:
                    self._bucketed.on_add(slot, self.bank.matrix()[slot])
            if self._device is not None:
                self._device.set_rows(
                    list(slot_of.values()),
                    np.stack([vec_of[k] for k in slot_of]),
                )
            return [slot_of[k] for k in keys]

    def remove(self, key: str) -> None:
        with self.bank.lock:
            slot = self.bank.remove(key)
            if slot is not None:
                if self._bucketed is not None:
                    self._bucketed.on_remove(slot)
                if self._device is not None:
                    self._device.clear_row(slot)

    def clear(self) -> None:
        with self.bank.lock:
            self.bank.clear()
            if self._bucketed is not None:
                self._bucketed.clear()
            if self._device is not None:
                self._device.clear()

    def autotune(self, **thresholds) -> Optional[str]:
        """One LSH auto-tuning step from live telemetry (``bucketed`` and
        ``auto`` backends; None otherwise), under ``bank.lock``; see
        :meth:`BucketedIndex.autotune` for the rules."""
        if self._bucketed is None:
            return None
        with self.bank.lock:
            return self._bucketed.autotune(**thresholds)

    def telemetry(self) -> dict:
        """Live counters: the device bank's upload accounting and, on the
        LSH backends, the recall/candidate statistics."""
        out: dict = {"backend": self.backend, "size": len(self.bank)}
        if self._device is not None:
            out["device"] = self._device.telemetry()
        if self._bucketed is not None:
            out["bucketed"] = self._bucketed.telemetry.snapshot()
        return out

    # -- search -----------------------------------------------------------

    def _as_queries(self, queries: Union[Sequence[str], np.ndarray]) -> np.ndarray:
        if isinstance(queries, np.ndarray):
            return np.atleast_2d(queries.astype(np.float32, copy=False))
        return embed_batch(list(queries))

    def topk(
        self, queries: Union[Sequence[str], np.ndarray], k: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over live keys: (scores (Q, k) f32, slots (Q, k) i32).

        ``queries`` is raw texts (embedded in one batch) or an embedded
        (Q, DIM) array. Every returned ``slot >= 0`` is a live key. Freed
        and never-used arena rows score 0.0 in the scan; their positions
        are masked to (-1, NEG_INF) here, not re-compacted, so with
        tombstones present fewer than k live entries may come back.
        """
        q = self._as_queries(queries)
        # the span closes after the results are on the host, so it covers
        # the device's time as well as the launch
        with trace_span(SPAN_INDEX_TOPK, backend=self.backend,
                        q=int(q.shape[0]), k=k, **self.obs_labels) as sp:
            if self.backend in ("pallas", "device"):
                from repro_torch.kernels import ops

                # the full arena is searched, and Q padded to a power of two
                # >= 8, as in the reference (whose jit'd kernel needs few shapes)
                nq = q.shape[0]
                qp = max(8, 1 << max(0, nq - 1).bit_length())
                if qp != nq:
                    q = np.pad(q, ((0, qp - nq), (0, 0)))
                with self.bank.lock:
                    qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
                    if self._device is not None:
                        # resident bank: only the query batch crosses to the card
                        self._device.note_h2d(q.nbytes)
                        sp.set(h2d_bytes=int(q.nbytes))
                        s, i = ops.resident_topk(qt, self._device.arena, k=k)
                    else:
                        s, i = ops.batch_topk(qt, self.bank.arena(), k=k)
                    scores, slots = s[:nq].cpu().numpy(), i[:nq].cpu().numpy()
            elif self._bucketed is not None:  # bucketed | auto
                cand0 = self._bucketed.telemetry.candidates_total
                scores, slots = self._bucketed.topk(q, k)
                sp.set(lsh_candidates=self._bucketed.telemetry.candidates_total - cand0)
            else:
                scores, slots = _brute_topk(self.bank.matrix(), q, k)
        # mask tombstoned / beyond-high-water slots: slot >= 0 => live key
        for r in range(slots.shape[0]):
            for c in range(slots.shape[1]):
                slot = slots[r, c]
                if slot >= 0 and self.bank.key_of(int(slot)) is None:
                    slots[r, c] = -1
                    scores[r, c] = NEG_INF
        return scores, slots

    def best_match_batch(
        self,
        queries: Union[Sequence[str], np.ndarray],
        threshold: float = 0.8,
    ) -> List[Optional[str]]:
        """Per query: the best live key with cosine >= threshold, else None."""
        scores, slots = self.topk(queries, k=1)
        out: List[Optional[str]] = []
        for r in range(scores.shape[0]):
            key = None
            if slots[r, 0] >= 0 and scores[r, 0] >= threshold:
                key = self.bank.key_of(int(slots[r, 0]))
            out.append(key)
        return out

    def best_match(
        self, query: Union[str, np.ndarray], threshold: float = 0.8
    ) -> Optional[str]:
        if isinstance(query, str):
            query = embed(query)
        # pallas/device answer through the batched device call; the host
        # backends take the lean single-lookup path (no (Q, k) arrays)
        if self.backend not in ("pallas", "device"):
            q = query.astype(np.float32, copy=False).reshape(-1)
            if self._bucketed is not None:
                score, slot = self._bucketed.best_slot(q)
            else:
                M = self.bank.matrix()
                if M.shape[0] == 0:
                    return None
                s = M @ q
                slot = int(np.argmax(s))
                score = float(s[slot])
            if slot >= 0 and score >= threshold:
                return self.bank.key_of(slot)
            return None
        return self.best_match_batch(query.reshape(1, -1), threshold)[0]


__all__ = [
    "BACKENDS",
    "DIM",
    "NEG_INF",
    "BucketedIndex",
    "DeviceBank",
    "EmbeddingBank",
    "SimilarityIndex",
    "embed",
    "embed_batch",
]
