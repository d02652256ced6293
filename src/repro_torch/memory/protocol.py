"""The plan-store contract (the twin of ``repro.memory.protocol``, without
the metrics registry).

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

from typing import Any, Optional, TypeVar

V = TypeVar("V")


class CacheStats:
    """Hit/miss/insert/evict accounting for one plan store: plain counters,
    written under the owning store's lock."""

    _FIELDS = ("hits", "misses", "inserts", "evictions", "lookup_time_s",
               "stale_insert_skips")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0.0 if f == "lookup_time_s" else 0)


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


__all__ = ["CacheStats", "PlanStoreBase", "V"]
