"""Latency optimizations the paper names as future work (§4.3), the twin
of ``repro.core.speculative``:

  * speculative next-query prefetch — predict the next keyword from the
    observed keyword bigram stream and pre-warm its template: touch it if
    resident (LRU order), or generate it before the query arrives;
  * speculative near-hit execution — on a fuzzy/semantic near hit the
    router serves the adapted template at once while the large planner
    verifies in the background; :class:`PlanSpeculator` owns the
    commit/rollback protocol (one :class:`~repro_torch.core.journal.StepJournal`
    per speculation, so verifications may complete out of order).
"""

from __future__ import annotations

import threading
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import PlanCache
from repro_torch.core.journal import StepJournal


class KeywordPredictor:
    """First-order Markov model over the keyword stream."""

    def __init__(self):
        self._bigram: Dict[str, Counter] = defaultdict(Counter)
        self._prev: Optional[str] = None
        self._lock = threading.Lock()

    def observe(self, keyword: str) -> None:
        with self._lock:
            if self._prev is not None:
                self._bigram[self._prev][keyword] += 1
            self._prev = keyword

    def predict(self, k: int = 3) -> List[str]:
        with self._lock:
            if self._prev is None or self._prev not in self._bigram:
                return []
            return [kw for kw, _ in self._bigram[self._prev].most_common(k)]


class SpeculativePrefetcher:
    """Pre-warms the plan cache for predicted next keywords.

    ``generate_fn(keyword)`` produces a template offline (e.g. replaying a
    stored exemplar task through the large planner during idle cycles);
    when it's None the prefetcher only performs an LRU *touch* so hot
    templates survive eviction pressure.
    """

    def __init__(
        self,
        cache: PlanCache,
        predictor: KeywordPredictor,
        generate_fn: Optional[Callable[[str], object]] = None,
    ):
        self.cache = cache
        self.predictor = predictor
        self.generate_fn = generate_fn
        self.prefetches = 0
        self.generated = 0

    def on_request(self, keyword: str) -> None:
        self.predictor.observe(keyword)
        for kw in self.predictor.predict():
            if kw in self.cache:
                self.cache.lookup(kw)  # LRU touch keeps it resident
                self.prefetches += 1
            elif self.generate_fn is not None:
                tpl = self.generate_fn(kw)
                if tpl is not None:
                    self.cache.insert(kw, tpl)
                    self.generated += 1
                    self.prefetches += 1


class PlanSpeculator:
    """Commit/rollback controller for near-hit speculation.

    Each speculation gets its own :class:`StepJournal` (verifications
    complete in any order, so one shared prefix-commit journal would
    stall): ``begin`` applies the eager env effect through the journal and
    defers the cache admission and the commit-side metric bumps; ``resolve``
    commits (the verifier agreed) or rolls back (it disagreed). With
    ``rollback_enabled=False`` a disagreeing speculation commits anyway
    (counted in ``forced_commits``).

    ``pending()`` is the liveness surface: every speculation begun must be
    resolved by quiescence, which the router guarantees by verifying
    synchronously when its pool rejects the task.

    Single-owner per the journal contract: begin/resolve run on one logical
    thread (the threaded router resolves under its lock).
    """

    def __init__(self, *, rollback_enabled: bool = True):
        self.rollback_enabled = rollback_enabled
        self._next_id = 0
        self._pending: Dict[int, Tuple[str, StepJournal]] = {}
        self.begun = 0
        self.commits = 0
        self.rollbacks = 0
        self.forced_commits = 0  # rollback disabled: disagreed but committed

    def begin(
        self,
        kw: str,
        *,
        effect: Optional[Callable[[], Callable[[], None]]] = None,
        on_commit: Sequence[Callable[[], None]] = (),
    ) -> int:
        """Open a speculation on ``kw``. ``effect`` applies the eager env
        write and returns its compensation; ``on_commit`` actions (cache
        admission with its pre-captured ``unless_written_since`` token,
        metric increments) run only if the verifier agrees."""
        journal = StepJournal()
        step = journal.begin_step(f"spec:{kw}")
        if effect is not None:
            step.applied(effect())
        for action in on_commit:
            step.on_commit(action)
        spec_id = self._next_id
        self._next_id += 1
        self._pending[spec_id] = (kw, journal)
        self.begun += 1
        return spec_id

    def resolve(self, spec_id: int, agree: bool) -> str:
        """Complete a speculation: returns "commit" or "rollback"."""
        kw, journal = self._pending.pop(spec_id)
        if agree or not self.rollback_enabled:
            journal.commit()
            if agree:
                self.commits += 1
            else:
                self.forced_commits += 1
            return "commit"
        journal.rollback()
        self.rollbacks += 1
        return "rollback"

    def pending(self) -> int:
        return len(self._pending)

    def pending_keys(self) -> List[str]:
        return sorted(kw for kw, _ in self._pending.values())

    def stats(self) -> Dict[str, Any]:
        return {
            "begun": self.begun,
            "commits": self.commits,
            "rollbacks": self.rollbacks,
            "forced_commits": self.forced_commits,
            "pending": self.pending(),
        }
