"""Fault plans, the shard-call fault interceptor and the sim cachegen pool
(the twin of ``repro.sim.faults``).

Faults are scheduled through :class:`repro_torch.distributed.fault.FaultSchedule`
— the same ``inject(step, kind, **details)`` path the training-side
``FaultTolerantRunner`` uses — and fire at their step inside the scheduler
loop. The built-in plans each target one guard in the serving /
distributed layers; ablating that guard (``SimConfig.ablate``) must make
an oracle fire, which is how the sim proves its oracles have teeth:

========================  ==========================================  ===========================
plan                      guard under test                            ablation key
========================  ==========================================  ===========================
``crash_restart``         lookup fallthrough past an unreachable      ``crash_fallthrough``
                          shard + ``restart_node`` read-repair
``replica_lag``           synchronous replica acks                    ``replica_ack``
                          (``ack_policy="all"``)
``hedge_timeout``         hedged-dispatch failover in ``TierPool``    ``hedge_failover``
``mid_wave_evict``        evict-AFTER-admission-wave in ``PlanCache``  ``evict_after_wave``
``membership_churn``      ring changes re-home data (``add_node``     ``churn_rehome``
                          rebalances, ``remove_node`` drains)
``async_cachegen``        rejected-submission sync fallback in        ``cachegen_fallback``
                          ``TwoTierRouter`` (no dropped waves)
``cold_tier``             manifest-refcounted cold-segment gc in      ``cold_gc_refcount``
                          ``ColdTier`` (age rotation must never
                          delete a segment with live entries)
``ttl_churn``             expire-on-touch in ``PlanCache._get_live``  ``ttl_expiry``
                          (an expired entry must never be served)
``speculative_exec``      journal rollback on a failed speculation    ``spec_rollback``
                          (``PlanSpeculator.resolve`` must undo every
                          journaled effect when the verifier
                          disagrees); the plan ALSO audits the
                          verify-timeout fallback under
                          ``spec_verify_timeout`` (see
                          ``EXTRA_PLAN_ABLATIONS``)
========================  ==========================================  ===========================

One guard is tied to a *scenario* rather than a fault plan: the fuzzy
scatter in ``DistributedPlanCache._probe_order`` (a similar key hashes to
its own owners, so fuzzy reads must reach every shard). Its ablation key
is ``fuzzy_scatter`` and the ``paraphrase_burst`` scenario's
similarity-aware oracle catches it (``SCENARIO_ABLATION_OF``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Set

from repro_torch.core.distributed_cache import ShardUnavailable
from repro_torch.distributed.fault import FaultSchedule
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.scheduler import StepScheduler

FAULT_PLANS = ("none", "crash_restart", "replica_lag", "hedge_timeout",
               "mid_wave_evict", "membership_churn", "async_cachegen",
               "cold_tier", "ttl_churn", "speculative_exec")

# guard-ablation keys, by the plan whose oracle they trip
ABLATION_OF = {
    "crash_restart": "crash_fallthrough",
    "replica_lag": "replica_ack",
    "hedge_timeout": "hedge_failover",
    "mid_wave_evict": "evict_after_wave",
    "membership_churn": "churn_rehome",
    "async_cachegen": "cachegen_fallback",
    "cold_tier": "cold_gc_refcount",
    "ttl_churn": "ttl_expiry",
    "speculative_exec": "spec_rollback",
}

# guard-ablation keys tripped by a traffic scenario instead of a fault plan
SCENARIO_ABLATION_OF = {
    "paraphrase_burst": "fuzzy_scatter",
}

# second-guard audits: plans that protect MORE than one guard get extra
# audit cells beyond ABLATION_OF (one fault plan, a different ablation
# key, a different oracle expected to fire). A pure literal, as in the
# reference, whose docs checker reads it through the AST.
EXTRA_PLAN_ABLATIONS = {
    "speculative_exec": "spec_verify_timeout",
}

ALL_ABLATIONS = tuple(sorted(
    set(ABLATION_OF.values()) | set(SCENARIO_ABLATION_OF.values())
    | set(EXTRA_PLAN_ABLATIONS.values())
))


class SimInterceptor:
    """Installed as ``DistributedPlanCache.interceptor``: the RPC layer of
    the simulated cluster. Crashed nodes raise :class:`ShardUnavailable`
    at call time (the facade has NOT been told via ``mark_down`` — crash
    discovery happens exactly where it would in production, at dispatch).
    ``defer`` models replica lag: the write applies ``lag_steps`` scheduler
    steps later, unless the node crashes first."""

    def __init__(
        self,
        scheduler: StepScheduler,
        clock: VirtualClock,
        *,
        call_latency_s: float = 2e-4,
        on_deferred: Optional[Callable[[str], None]] = None,
    ):
        self.scheduler = scheduler
        self.clock = clock
        self.call_latency_s = call_latency_s
        self.on_deferred = on_deferred
        self.crashed: Set[str] = set()
        self.lag_steps = 0
        self.calls = 0
        self.failed_calls = 0
        self.deferred_writes = 0

    # -- DistributedPlanCache seam ------------------------------------------

    def call(self, node: str, op: str, fn: Callable[[], object]) -> object:
        self.calls += 1
        self.clock.advance(self.call_latency_s)
        if node in self.crashed:
            self.failed_calls += 1
            raise ShardUnavailable(f"{node} unreachable ({op})")
        return fn()

    def defer(self, node: str, fn: Callable[[], None]) -> None:
        """Replica-lag channel (used only under the ``replica_ack``
        ablation): apply the write after ``lag_steps`` steps."""
        self.deferred_writes += 1

        def apply() -> None:
            if node in self.crashed:
                return  # the lagged write dies with the crashed node
            fn()
            if self.on_deferred is not None:
                self.on_deferred(node)

        self.scheduler.defer(max(1, self.lag_steps), apply)

    # -- fault-plan state ----------------------------------------------------

    def crash(self, node: str) -> None:
        self.crashed.add(node)

    def restore(self, node: str) -> None:
        self.crashed.discard(node)


class SimCachegenFuture:
    """Future-compatible handle for a scheduler-driven cachegen task."""

    def __init__(self) -> None:
        self._done = False
        self._result: Any = None

    def set_result(self, value: Any) -> None:
        self._done = True
        self._result = value

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done:
            # the scheduler runs every queued worker op before quiescence,
            # so an unresolved future at drain() time is a harness bug
            raise RuntimeError("sim cachegen task never ran")
        return self._result

    def cancel(self) -> bool:
        return False


class SimCachegenPool:
    """The router's async cache-generation worker pool, as sim clients.

    Injected as ``TwoTierRouter(cachegen_pool=...)``: instead of a
    ThreadPoolExecutor, ``submit`` appends a ``{"op": "cachegen"}`` task to
    one of N pre-registered worker clients (round-robin) on the step
    scheduler — so the seeded scheduler, not a thread race, decides when a
    distilled admission wave lands relative to concurrent lookups, inserts
    and removals. That is exactly the §4.3 admission race the paper defers.

    ``arm_saturation(calls)`` makes the next ``calls`` submissions raise
    (an injected "pool saturated" rejection): the router's guarded response
    is the synchronous fallback; with ``cachegen_fallback`` ablated the
    wave is dropped, which the harness's ``cachegen_loss`` oracle catches.
    """

    def __init__(
        self,
        scheduler: StepScheduler,
        clock: VirtualClock,
        *,
        workers: int = 2,
        submit_latency_s: float = 1e-4,
    ):
        self.scheduler = scheduler
        self.clock = clock
        self.submit_latency_s = submit_latency_s
        self.worker_names = [f"cachegen-{i}" for i in range(workers)]
        for name in self.worker_names:
            scheduler.add_client(name, [])
        self._rr = 0
        self.saturate_budget = 0
        self.submitted = 0
        self.rejected = 0

    def arm_saturation(self, calls: int) -> None:
        self.saturate_budget = calls

    def submit(self, fn: Callable[[], Any]) -> SimCachegenFuture:
        self.clock.advance(self.submit_latency_s)
        if self.saturate_budget > 0:
            self.saturate_budget -= 1
            self.rejected += 1
            raise RuntimeError("cachegen pool saturated (injected fault)")
        fut = SimCachegenFuture()
        worker = self.worker_names[self._rr % len(self.worker_names)]
        self._rr += 1
        self.scheduler.extend_client(
            worker, [{"op": "cachegen", "fn": fn, "future": fut}]
        )
        self.submitted += 1
        return fut


class EngineFaultState:
    """Hedge-timeout fault state shared with the sim's fake tier engines:
    while ``budget > 0``, the named engine raises ``TimeoutError`` (one
    budget unit per raised call)."""

    def __init__(self) -> None:
        self.timeout_engine: Optional[str] = None
        self.budget = 0

    def arm(self, engine: str, calls: int) -> None:
        self.timeout_engine = engine
        self.budget = calls

    def should_timeout(self, engine: str) -> bool:
        if self.budget > 0 and engine == self.timeout_engine:
            self.budget -= 1
            return True
        return False


def build_fault_schedule(plan: str, n_steps: int, *, node: str = "cache-1",
                         lag_steps: int = 6) -> FaultSchedule:
    """Materialize a named plan into step-indexed fault events.

    Events (consumed by the harness's ``on_fault``):
      * ``crash``/``restart``  — node lifecycle (two cycles per run);
      * ``lag``                — set the interceptor's replica lag;
      * ``hedge_timeout``      — arm the large-tier engine timeout;
      * ``evict_pressure``     — marker only: the mid-wave plan does its
        damage through config (tiny capacity + flood waves), not events;
      * ``join``/``drain``     — elastic membership: ``add_node`` a fresh
        node mid-wave / gracefully ``remove_node`` one, racing the client
        traffic (``membership_churn``);
      * ``pool_saturate``      — arm N rejected cachegen submissions on
        the sim worker pool (``async_cachegen``);
      * ``cold_crash``         — arm N spill-wave crashes between segment
        write and manifest commit on store AND model (``cold_tier``): the
        entries are lost on both sides, deterministically, proving the
        two-phase spill ordering is mirrored;
      * ``ttl_pressure``       — marker only: the ttl plan does its damage
        through config (short ``ttl_s`` against skewed reuse gaps).
    """
    if plan not in FAULT_PLANS:
        raise ValueError(f"unknown fault plan {plan!r}; one of {FAULT_PLANS}")
    sched = FaultSchedule()
    if plan == "none":
        return sched
    q = max(8, n_steps // 4)
    if plan == "crash_restart":
        sched.inject(q, "crash", node=node)
        sched.inject(2 * q, "restart", node=node, recover=True)
        sched.inject(2 * q + q // 2, "crash", node=node)
        sched.inject(3 * q + q // 2, "restart", node=node, recover=True)
    elif plan == "replica_lag":
        sched.inject(2, "lag", steps=lag_steps)
        # crash a node mid-lag: readers must fall through to replicas that
        # (under the sync-ack guard) already hold the acked versions
        sched.inject(q, "crash", node=node)
        sched.inject(3 * q, "restart", node=node, recover=True)
    elif plan == "hedge_timeout":
        sched.inject(q, "hedge_timeout", engine="large-0", calls=8)
        sched.inject(3 * q, "hedge_timeout", engine="large-0", calls=8)
    elif plan == "mid_wave_evict":
        sched.inject(q, "evict_pressure")
    elif plan == "membership_churn":
        # join mid-wave, graceful drain racing lookups, a crash held open
        # across a join (rebalance with an unreachable shard), a restart
        # whose read-repair runs against the post-churn ring, and a drain
        # of the earlier joiner — every ring change mirrored by the model
        sched.inject(q // 2, "join", node="cache-join-0")
        sched.inject(q, "drain", node=node)
        sched.inject(2 * q, "crash", node="cache-2")
        sched.inject(2 * q + 2, "join", node="cache-join-1")
        sched.inject(3 * q, "restart", node="cache-2", recover=True)
        sched.inject(3 * q + q // 2, "drain", node="cache-join-0")
    elif plan == "async_cachegen":
        # two bursts of rejected cachegen submissions: the guarded router
        # falls back to synchronous generation; the ablated router drops
        # the distilled waves (cachegen_loss oracle)
        sched.inject(q, "pool_saturate", calls=6)
        sched.inject(3 * q, "pool_saturate", calls=6)
    elif plan == "cold_tier":
        # lose one spill wave mid-run and one late: a crash between the
        # segment write and the manifest commit must lose the wave WHOLE
        # (no template both lost and unevicted) on store and model alike
        sched.inject(q, "cold_crash", calls=1)
        sched.inject(3 * q, "cold_crash", calls=1)
    elif plan == "ttl_churn":
        sched.inject(q, "ttl_pressure")
    elif plan == "speculative_exec":
        # three bursts of rejected pool submissions: near-hit verify tasks
        # share the cachegen pool, so some rejections hit verifies — the
        # guarded router verifies synchronously (spec_sync_verifies); the
        # spec_verify_timeout ablation drops them, leaving speculations
        # pending forever (spec_liveness oracle). Bursts are wide enough
        # that every seed rejects at least one verify submission.
        sched.inject(q // 2, "pool_saturate", calls=10)
        sched.inject(2 * q, "pool_saturate", calls=10)
        sched.inject(3 * q, "pool_saturate", calls=10)
    return sched


__all__ = [
    "ABLATION_OF",
    "ALL_ABLATIONS",
    "EXTRA_PLAN_ABLATIONS",
    "EngineFaultState",
    "FAULT_PLANS",
    "SCENARIO_ABLATION_OF",
    "SimCachegenFuture",
    "SimCachegenPool",
    "SimInterceptor",
    "build_fault_schedule",
]
