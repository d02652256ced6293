"""repro_torch.index — the similarity index behind the fuzzy and semantic
match stages (the twin of ``repro.index``).

* :class:`~repro_torch.index.bank.EmbeddingBank` — float32 slot arena with a
  freelist (O(1) add/remove) and the batched hashed-ngram embedding.
* ``ops.batch_topk`` / ``ops.resident_topk`` — cosine top-k, one call per
  request batch: the CUDA kernel on the card, the plain version on the CPU.
* :class:`~repro_torch.index.device.DeviceBank` — the arena mirrored on the
  card, written in place, searched with no bank bytes uploaded per lookup.

:class:`SimilarityIndex` is the facade: pick a backend (``brute`` |
``pallas`` | ``device``) and get add/remove/topk/best_match over keys.
``brute`` is the exact numpy scan on the host. ``pallas`` uploads the host
arena to ``device`` on every call and searches it there; ``device`` keeps a
``DeviceBank`` on ``device`` in lockstep with the host arena. The
reference's ``bucketed`` (multi-probe LSH) and ``auto`` backends are not
ported yet and raise.

Thread-safety: all mutation takes ``self.bank.lock`` and updates the host
and device arenas together. ``pallas``/``device`` searches run under
``bank.lock``; a ``brute`` search reads the arena as it is, and callers
that need a consistent view hold the lock (``PlanCache`` wraps every index
call in its own lock).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.index.bank import DIM, EmbeddingBank, embed, embed_batch
from repro_torch.index.device import DeviceBank

BACKENDS = ("brute", "pallas", "device")
NOT_PORTED = ("auto", "bucketed")
NEG_INF = -1e30


def _brute_topk(
    matrix: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact numpy top-k over ``matrix`` rows (a copy of
    ``repro.index.bucketed._brute_topk``)."""
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


class SimilarityIndex:
    """Key -> embedding store with a pluggable top-k search backend.

    ``device`` is where the ``pallas`` and ``device`` backends search:
    CUDA unless the caller asks for another (the tests pass ``"cpu"``,
    which runs the plain version). ``brute`` always scans on the host.
    """

    def __init__(
        self,
        *,
        backend: str = "brute",
        initial_capacity: int = 64,
        device=None,
    ):
        if backend in NOT_PORTED:
            raise ValueError(
                f"index backend {backend!r} is not ported yet (the LSH "
                f"BucketedIndex is; see ROADMAP); use one of {BACKENDS}"
            )
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.backend = backend
        self.bank = EmbeddingBank(initial_capacity)
        self.device: Optional[torch.device] = None
        self._device: Optional[DeviceBank] = None
        if backend in ("pallas", "device"):
            from repro_torch.models.common import resolve_device

            self.device = resolve_device(device)
        if backend == "device":
            self._device = DeviceBank(self.bank.arena().shape[0], device=self.device)

    # -- mutation ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.bank)

    def __contains__(self, key: str) -> bool:
        return key in self.bank

    def add(self, key: str, vector: Optional[np.ndarray] = None) -> int:
        with self.bank.lock:
            slot = self.bank.add(key, vector)
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
                slot_of[key] = self.bank.add(key, vec)
            if self._device is not None:
                self._device.set_rows(
                    list(slot_of.values()),
                    np.stack([vec_of[k] for k in slot_of]),
                )
            return [slot_of[k] for k in keys]

    def remove(self, key: str) -> None:
        with self.bank.lock:
            slot = self.bank.remove(key)
            if slot is not None and self._device is not None:
                self._device.clear_row(slot)

    def clear(self) -> None:
        with self.bank.lock:
            self.bank.clear()
            if self._device is not None:
                self._device.clear()

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
                    s, i = ops.resident_topk(qt, self._device.arena, k=k)
                else:
                    s, i = ops.batch_topk(qt, self.bank.arena(), k=k)
                scores, slots = s[:nq].cpu().numpy(), i[:nq].cpu().numpy()
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
        if self.backend == "brute":  # the lean host single-lookup path
            q = query.astype(np.float32, copy=False).reshape(-1)
            M = self.bank.matrix()
            if M.shape[0] == 0:
                return None
            s = M @ q
            slot = int(np.argmax(s))
            if slot >= 0 and float(s[slot]) >= threshold:
                return self.bank.key_of(slot)
            return None
        return self.best_match_batch(query.reshape(1, -1), threshold)[0]


__all__ = [
    "BACKENDS",
    "DIM",
    "NEG_INF",
    "DeviceBank",
    "EmbeddingBank",
    "SimilarityIndex",
    "embed",
    "embed_batch",
]
