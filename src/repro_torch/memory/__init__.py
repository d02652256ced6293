"""repro_torch.memory — the plan-store API: protocol, policies, pipeline,
registry (the twin of ``repro.memory``).

This package is the contract layer between the APC test-time memory and
everything that consumes it:

* :mod:`repro_torch.memory.protocol`  — :class:`PlanStore`, the
  batch-native store protocol (``lookup_batch``/``insert_batch`` primitive,
  singular ops are :class:`PlanStoreBase` wrappers), plus
  :class:`CacheStats`;
* :mod:`repro_torch.memory.policies`  — composable :class:`EvictionPolicy`
  objects (``lru`` | ``lfu`` | ``ttl`` | ``cost``), paper §4.4;
* :mod:`repro_torch.memory.pipeline`  — :class:`MatchPipeline` of
  exact -> fuzzy -> semantic :class:`MatchStage` resolution stages;
* :mod:`repro_torch.memory.tiered`  — the cold tier (:class:`ColdTier`)
  that evicted plans spill into;
* :mod:`repro_torch.memory.registry`  — the ``@register_method``
  agent-strategy registry the harness enumerates.

Implementations live in ``repro_torch.core``
(:class:`~repro_torch.core.cache.PlanCache`,
:class:`~repro_torch.core.distributed_cache.DistributedPlanCache`, the
method strategies in :mod:`repro_torch.core.methods`).
"""

from repro_torch.memory.pipeline import (
    ExactStage,
    FuzzyStage,
    MatchPipeline,
    MatchStage,
    SemanticStage,
    build_pipeline,
)
from repro_torch.memory.policies import (
    EVICTION_POLICIES,
    CacheEntry,
    CostAwarePolicy,
    EvictionPolicy,
    LFUPolicy,
    LRUPolicy,
    TTLPolicy,
    make_policy,
)
from repro_torch.memory.protocol import CacheStats, PlanStore, PlanStoreBase
from repro_torch.memory.tiered import ColdEntry, ColdTier, compact_template
from repro_torch.memory.registry import (
    METHOD_REGISTRY,
    AgentMethod,
    get_method_class,
    make_method,
    method_names,
    register_method,
)

__all__ = [
    "AgentMethod",
    "CacheEntry",
    "CacheStats",
    "ColdEntry",
    "ColdTier",
    "CostAwarePolicy",
    "EVICTION_POLICIES",
    "EvictionPolicy",
    "ExactStage",
    "FuzzyStage",
    "LFUPolicy",
    "LRUPolicy",
    "MatchPipeline",
    "MatchStage",
    "METHOD_REGISTRY",
    "PlanStore",
    "PlanStoreBase",
    "SemanticStage",
    "TTLPolicy",
    "build_pipeline",
    "compact_template",
    "get_method_class",
    "make_method",
    "make_policy",
    "method_names",
    "register_method",
]
