"""Fuzzy keyword matching over the port's index (the twin of
``repro.core.fuzzy``).

The hashed-ngram embedding stands in for the paper prototype's
SentenceTransformer encoder; it lives in ``repro_torch.index.bank`` and is
re-exported here with ``DIM``, beside ``similarity`` and
:class:`FuzzyMatcher`, a view over a
:class:`~repro_torch.index.SimilarityIndex` (backends ``brute``,
``pallas``, ``device``, ``bucketed``, ``auto``; ``pallas`` and ``device``
search on ``device``, CUDA unless the caller asks for another). The plan
cache's fuzzy stage (``memory/pipeline.py::FuzzyStage``) is the same
matcher folded into the match pipeline.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.index import SimilarityIndex
from repro_torch.index.bank import DIM, embed, embed_batch  # noqa: F401  (re-export)


def similarity(a: str, b: str) -> float:
    e = embed_batch([a, b])
    return float(e[0] @ e[1])


class FuzzyMatcher:
    """Key matcher backed by a SimilarityIndex. ``best_match``'s ``keys``
    argument reconciles the index with a key set the caller owns (O(N));
    incremental ``add``/``remove`` is the fast path."""

    def __init__(self, backend: str = "auto", **index_kw):
        self.index = SimilarityIndex(backend=backend, **index_kw)

    def add(self, key: str, vector=None) -> None:
        self.index.add(key, vector)

    def add_batch(self, keys: List[str], vectors=None) -> None:
        """One embedding batch for the wave (``vectors`` skips embedding)
        and, on the ``device`` backend, one device write."""
        self.index.add_batch(keys, vectors)

    def remove(self, key: str) -> None:
        self.index.remove(key)

    def clear(self) -> None:
        self.index.clear()

    def _sync(self, keys: List[str]) -> None:
        want = set(keys)
        have = set(self.index.bank.keys())
        for k in have - want:
            self.index.remove(k)
        for k in want - have:
            self.index.add(k)

    def best_match(self, query: str, keys: Optional[List[str]] = None,
                   threshold: float = 0.8) -> Optional[str]:
        if keys is not None:
            self._sync(keys)
        return self.index.best_match(query, threshold)

    def best_match_batch(self, queries: List[str], threshold: float = 0.8
                         ) -> List[Optional[str]]:
        """All queries embedded at once and answered by one top-k call."""
        return self.index.best_match_batch(queries, threshold)


__all__ = ["DIM", "FuzzyMatcher", "embed", "embed_batch", "similarity"]
