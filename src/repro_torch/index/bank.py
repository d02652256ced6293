"""EmbeddingBank: a contiguous float32 slot arena for similarity search
(a copy of ``repro.index.bank``; numpy, no framework).

Keys live in a preallocated ``(capacity, DIM)`` arena with a freelist, so
add/remove are O(1) and no matrix is rebuilt on the lookup path: the search
backends (the brute numpy scan, the per-call upload of the ``pallas``
backend, the ``DeviceBank`` mirror) all read the arena or its live prefix
``matrix()``.

Freed slots are zeroed, so they score exactly 0.0 under cosine; top-k
consumers also filter via ``bank.key_of(slot) is None``. Slot numbers decide
ties (the lowest row wins), so the freelist order matches the reference's
exactly: ``range(cap - 1, -1, -1)``, popped from the end.

The hashed character-ngram embedding is batched: gram -> (dim index, sign)
hashing is memoized and accumulated by one ``np.add.at`` scatter. Gram
contributions are exact +/-1.0 float32 integers, so the result is
bit-identical to the reference's.

Thread-safety: every mutator takes ``self.lock`` (an RLock). Reads of
``matrix()`` / ``arena()`` / ``vector()`` return live views; a reader that
must not observe concurrent writes holds ``bank.lock`` around the read.
``SimilarityIndex`` nests its device-arena updates inside that lock, and
``PlanCache`` wraps every index call in its own lock.
"""

from __future__ import annotations

import hashlib
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DIM = 384  # matches MiniLM-L6 dim (the paper prototype's encoder)


# ---------------------------------------------------------------------------
# hashed-ngram embedding (batched)
# ---------------------------------------------------------------------------

_GRAM_CACHE: Dict[str, Tuple[int, np.float32]] = {}
_GRAM_CACHE_MAX = 1 << 20  # bound memory on adversarial workloads


def _tokens(text: str) -> List[str]:
    text = text.lower()
    words = re.findall(r"[a-z0-9]+", text)
    grams = list(words)
    for w in words:
        for i in range(len(w) - 2):
            grams.append(w[i : i + 3])
    for a, b in zip(words, words[1:]):
        grams.append(a + "_" + b)
    return grams


def _gram_slot(g: str) -> Tuple[int, np.float32]:
    hit = _GRAM_CACHE.get(g)
    if hit is None:
        h = int.from_bytes(
            hashlib.blake2b(g.encode(), digest_size=8).digest(), "little"
        )
        hit = (h % DIM, np.float32(1.0 if (h >> 62) & 1 else -1.0))
        if len(_GRAM_CACHE) < _GRAM_CACHE_MAX:
            _GRAM_CACHE[g] = hit
    return hit


def embed_batch(texts: Sequence[str]) -> np.ndarray:
    """(len(texts), DIM) float32, rows L2-normalized (zero rows stay zero)."""
    out = np.zeros((len(texts), DIM), np.float32)
    rows: List[int] = []
    cols: List[int] = []
    signs: List[np.float32] = []
    for r, t in enumerate(texts):
        for g in _tokens(t):
            c, s = _gram_slot(g)
            rows.append(r)
            cols.append(c)
            signs.append(s)
    if rows:
        np.add.at(
            out,
            (np.asarray(rows, np.intp), np.asarray(cols, np.intp)),
            np.asarray(signs, np.float32),
        )
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    np.divide(out, norms, out=out, where=norms > 0)
    return out


def embed(text: str) -> np.ndarray:
    """Single-text convenience wrapper over :func:`embed_batch`."""
    return embed_batch([text])[0]


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------


class EmbeddingBank:
    """Slot arena mapping keys -> L2-normalized embedding rows.

    O(1) ``add``/``remove`` (freelist, no matrix rebuild); ``matrix()`` is a
    view of rows ``[0, high_water)``. Thread-safe for interleaved mutation;
    search backends should snapshot ``matrix()`` under ``bank.lock`` when
    racing with writers (``PlanCache`` already serializes via its own lock).
    """

    def __init__(self, initial_capacity: int = 64):
        cap = max(1, int(initial_capacity))
        self._arena = np.zeros((cap, DIM), np.float32)
        self._slot_of: Dict[str, int] = {}
        self._key_of: List[Optional[str]] = [None] * cap
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._high_water = 0
        self.lock = threading.RLock()

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, key: str) -> bool:
        return key in self._slot_of

    @property
    def high_water(self) -> int:
        return self._high_water

    def keys(self) -> List[str]:
        with self.lock:
            return list(self._slot_of)

    def slot_of(self, key: str) -> Optional[int]:
        return self._slot_of.get(key)

    def key_of(self, slot: int) -> Optional[str]:
        """Key occupying ``slot``, or None for freed/never-used slots."""
        if 0 <= slot < self._high_water:
            return self._key_of[slot]
        return None

    def matrix(self) -> np.ndarray:
        """Zero-copy (high_water, DIM) view; freed rows are all-zero."""
        return self._arena[: self._high_water]

    def arena(self) -> np.ndarray:
        """The full (capacity, DIM) arena; rows beyond high_water are zero.

        The ``pallas`` backend uploads and searches this, as the reference
        does: zero rows past ``high_water`` score 0.0 and are masked by
        ``key_of``."""
        return self._arena

    def vector(self, key: str) -> Optional[np.ndarray]:
        slot = self._slot_of.get(key)
        return None if slot is None else self._arena[slot]

    # -- mutation ---------------------------------------------------------

    def _grow(self) -> None:
        old = self._arena
        cap = old.shape[0] * 2
        self._arena = np.zeros((cap, DIM), np.float32)
        self._arena[: old.shape[0]] = old
        self._free.extend(range(cap - 1, old.shape[0] - 1, -1))
        self._key_of.extend([None] * (cap - old.shape[0]))

    def add(self, key: str, vector: Optional[np.ndarray] = None) -> int:
        """Insert ``key`` (embedding its text unless ``vector`` is given).

        Returns the slot. Re-adding an existing key is a no-op unless a new
        vector is supplied, in which case the row is overwritten in place.
        """
        with self.lock:
            slot = self._slot_of.get(key)
            if slot is not None:
                if vector is not None:
                    self._arena[slot] = np.asarray(vector, np.float32)
                return slot
            if vector is None:
                vector = embed(key)
            if not self._free:
                self._grow()
            slot = self._free.pop()
            self._slot_of[key] = slot
            self._key_of[slot] = key
            self._arena[slot] = np.asarray(vector, np.float32)
            self._high_water = max(self._high_water, slot + 1)
            return slot

    def remove(self, key: str) -> Optional[int]:
        """O(1) tombstone: zero the row, recycle the slot. Returns the slot."""
        with self.lock:
            slot = self._slot_of.pop(key, None)
            if slot is None:
                return None
            self._key_of[slot] = None
            self._arena[slot] = 0.0
            self._free.append(slot)
            return slot

    def clear(self) -> None:
        with self.lock:
            cap = self._arena.shape[0]
            self._arena[:] = 0.0
            self._slot_of.clear()
            self._key_of = [None] * cap
            self._free = list(range(cap - 1, -1, -1))
            self._high_water = 0
