"""``repro_torch.sim`` — deterministic simulation of the distributed plan
cache (the twin of ``repro.sim``).

FoundationDB-style verification of the serving and distributed layers: a
seeded virtual clock and step scheduler drive concurrent
``lookup_batch``/``insert_batch``/``remove``/``autotune`` and control-plane
``keys``/``len`` traffic (and router ``route_batch``, with async
cache-generation workers modelled as scheduler clients) against
``DistributedPlanCache`` / ``TwoTierRouter`` under injected faults — shard
crash/restart, membership churn, replica lag, hedged-dispatch timeouts,
rejected cachegen submissions, mid-wave eviction, cold-tier spill crashes,
TTL churn and speculation — and checks every run against a sequential
model-store oracle (similarity-aware in fuzzy mode). A failing run dumps a
replayable seed file, which either package replays.

On CUDA the fuzzy cells' shard indexes and the oracle's twin indexes sit on
the ``device`` backend, so every fuzzy lookup wave launches the top-k
kernel. Entry points::

    python -m repro_torch.sim --seed 7 --fault crash_restart   # on the card
    python -m repro_torch.sim --check --seeds 5 --device cpu   # the CI matrix
    python -m repro_torch.sim --replay sim-repro/failure.json

Library use::

    from repro_torch.sim import SimConfig, run_sim
    report = run_sim(SimConfig(seed=7, fault="membership_churn"), device="cpu")
    assert report.ok
"""

from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.faults import (
    ABLATION_OF,
    ALL_ABLATIONS,
    EXTRA_PLAN_ABLATIONS,
    FAULT_PLANS,
    SCENARIO_ABLATION_OF,
    SimCachegenPool,
    SimInterceptor,
)
from repro_torch.sim.harness import SimConfig, SimReport, run_sim
from repro_torch.sim.oracle import ModelStore, Violation, make_value, value_torn
from repro_torch.sim.scheduler import StepScheduler
from repro_torch.sim.trace import TraceRecorder

__all__ = [
    "ABLATION_OF",
    "ALL_ABLATIONS",
    "EXTRA_PLAN_ABLATIONS",
    "FAULT_PLANS",
    "ModelStore",
    "SCENARIO_ABLATION_OF",
    "SimCachegenPool",
    "SimConfig",
    "SimInterceptor",
    "SimReport",
    "StepScheduler",
    "TraceRecorder",
    "VirtualClock",
    "Violation",
    "make_value",
    "run_sim",
    "value_torn",
]
