"""Per-request cache attribution: where a hit came from and what it saved
(the twin of ``repro.obs.attribution``).

The router sees only ``lookup_batch -> Optional[template]``; the layers
below know which match stage resolved a query, which shard and replica tier
answered and which key matched. The router opens a context-local
:class:`AttributionCollector` around its lookup, every resolving layer calls
:func:`deposit` (a no-op when no collector is open), and facades re-map
indices as a batch narrows:

* ``PlanCache.lookup_batch`` deposits ``stage`` and ``matched_key`` at its
  local batch index;
* ``DistributedPlanCache.lookup_batch`` opens a nested collector around
  each shard call and re-deposits at its own indices with ``node`` and
  ``replica_tier`` added (the inner collector shadows the outer one for the
  length of the shard call);
* the router joins the detail with the §4.4 cost model
  (:func:`tokens_saved_estimate`) and emits one ``cache.attribution`` event
  per request. The ``speculative`` method reads ``stage`` the same way.

A collector is visible only to the call stack that opened it, so
concurrent waves never see each other's deposits.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Optional

_collector: ContextVar[Optional["AttributionCollector"]] = ContextVar(
    "repro_torch_obs_attribution", default=None
)


class AttributionCollector:
    """index -> merged attribution dict for one lookup batch."""

    __slots__ = ("info",)

    def __init__(self):
        self.info: Dict[int, Dict[str, Any]] = {}

    def deposit(self, i: int, **fields: Any) -> None:
        self.info.setdefault(i, {}).update(fields)

    def get(self, i: int) -> Dict[str, Any]:
        return self.info.get(i, {})

    def items(self):
        return self.info.items()


@contextmanager
def collect():
    """Open a collector for the enclosed lookup; nested opens shadow."""
    c = AttributionCollector()
    token = _collector.set(c)
    try:
        yield c
    finally:
        _collector.reset(token)


def deposit(i: int, **fields: Any) -> None:
    """Attach attribution fields to batch index ``i`` of the innermost
    open collector; silently a no-op when none is open (un-traced paths
    pay one contextvar read)."""
    c = _collector.get()
    if c is not None:
        c.deposit(i, **fields)


def tokens_saved_estimate(template: Any) -> int:
    """§4.4 cost-model attribution for one hit: the large-planner output
    tokens a cached template avoids regenerating. Templates that expose
    ``size_tokens()`` (:class:`repro_torch.core.template.PlanTemplate`) answer
    exactly; anything else is estimated from its serialized length (the
    chars/4 heuristic the cost model uses everywhere)."""
    size = getattr(template, "size_tokens", None)
    if callable(size):
        try:
            return int(size())
        except Exception:
            pass
    return max(1, len(str(template)) // 4)


__all__ = [
    "AttributionCollector",
    "collect",
    "deposit",
    "tokens_saved_estimate",
]
