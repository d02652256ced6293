"""The simulation harness: wire workload, store, router, faults and oracles
(the twin of ``repro.sim.harness``).

One :func:`run_sim` call is one deterministic universe: a seeded virtual
clock and step scheduler drive concurrent ``lookup_batch`` /
``insert_batch`` / ``remove`` / ``autotune`` / ``keys`` / ``len`` traffic
(and, for router scenarios, whole ``route_batch`` admission waves through
a ``TwoTierRouter`` over hedged ``TierPool``\\ s, with async
cache-generation workers modeled as scheduler clients) against a
``DistributedPlanCache`` while a fault plan crashes/restarts shards,
joins/drains membership, injects replica lag, rejects cachegen
submissions, or times out tier engines. Every applied operation is
simultaneously replayed on the sequential
:class:`~repro_torch.sim.oracle.ModelStore`; divergence is a
:class:`~repro_torch.sim.oracle.Violation`.

Determinism contract: ``run_sim(cfg)`` twice returns the identical
``trace_hash`` AND the identical ``span_digest`` — the run executes under
a ``repro_torch.obs`` tracer bound to the virtual clock, so the exported
span stream (ids, timestamps, attributes) is a pure function of ``(seed,
config)``, byte-identical across reruns. On violations the report carries
a replayable repro file (see ``repro_torch.sim.trace``).

``run_sim(cfg, device=, index_backend=)``: the device is where the fuzzy
shards' similarity indexes and the oracle's twin indexes live, CUDA unless
the caller asks for another. ``index_backend=None`` picks ``device`` on
CUDA (each fuzzy lookup wave launches the top-k kernel, in every shard
and every twin) and the reference's default, ``auto``, elsewhere, so a CPU
run hashes as the reference does. Neither is a ``SimConfig`` field: a
config dumped by either package replays in the other.
"""

from __future__ import annotations

import shutil
import tempfile
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.distributed_cache import DistributedPlanCache
from repro_torch.envs.base import Workspace, det_rng
from repro_torch.envs.workloads import SIM_SCENARIOS, sim_traffic
from repro_torch.models.common import resolve_device
from repro_torch.obs import InMemoryExporter, Tracer, use_tracer
from repro_torch.serving.router import TierPool, TwoTierRouter
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.faults import (
    ABLATION_OF,
    ALL_ABLATIONS,
    FAULT_PLANS,
    SCENARIO_ABLATION_OF,
    EngineFaultState,
    SimCachegenPool,
    SimInterceptor,
    build_fault_schedule,
)
from repro_torch.sim.oracle import ModelStore, Violation, make_value, value_torn
from repro_torch.sim.scheduler import StepScheduler
from repro_torch.sim.trace import TraceRecorder

# ablation keys consumed by DistributedPlanCache's own seams (the rest are
# consumed by the harness/router wiring below)
_STORE_ABLATIONS = ("crash_fallthrough", "evict_after_wave", "churn_rehome",
                    "fuzzy_scatter", "cold_gc_refcount", "ttl_expiry")


@dataclass
class SimConfig:
    seed: int = 0
    scenario: str = "skewed_reuse"  # see envs.workloads.SIM_SCENARIOS
    fault: str = "none"  # see faults.FAULT_PLANS
    n_ops: int = 60  # ops per client
    n_clients: int = 4
    batch: int = 4
    n_nodes: int = 4
    replication: int = 2
    capacity_per_node: int = 512
    eviction: str = "lru"
    fuzzy: bool = False
    fuzzy_threshold: float = 0.8
    router: bool = False  # drive route_batch through TwoTierRouter
    async_cachegen: bool = False  # model the cachegen pool as sim clients
    cachegen_workers: int = 2
    # speculative near-hit execution: fuzzy near-hits are served
    # immediately while a verify task (riding the cachegen pool, p~0.7
    # agreement) races them; the journaled effects commit or roll back
    speculate: bool = False
    lag_steps: int = 6
    ablate: Tuple[str, ...] = ()  # guard ablations (faults.ALL_ABLATIONS)
    # tiered-memory knobs: cold_tier spills capacity victims to an on-disk
    # segment tier (a per-run temp directory — the flag, not a path, lives
    # here so replay JSON stays machine-independent); ttl_s wraps the
    # eviction policy in expire-on-touch
    cold_tier: bool = False
    ttl_s: Optional[float] = None

    def normalized(self) -> "SimConfig":
        """Fill in plan-specific defaults (documented per fault plan)."""
        cfg = self
        if cfg.fault == "speculative_exec":
            # paraphrase traffic against a small fuzzy cluster: every
            # variant lookup that resolves fuzzily opens a speculation,
            # and the pool-saturation bursts force rejected verify
            # submissions through the sync-fallback guard. The short TTL
            # is load-bearing: a fuzzy hit promotes the variant to an
            # exact alias (and a variant-first miss admits under the
            # variant keyword), so without expiry the fuzzy window only
            # exists once per variant and some seeds never speculate —
            # churn re-opens it all run long
            cfg = replace(cfg, scenario="paraphrase_burst", speculate=True,
                          n_nodes=2, replication=1,
                          ttl_s=cfg.ttl_s if cfg.ttl_s is not None else 0.05)
        if cfg.speculate and not (cfg.router and cfg.async_cachegen):
            cfg = replace(cfg, router=True, async_cachegen=True)
        if cfg.fault == "hedge_timeout" and not cfg.router:
            cfg = replace(cfg, router=True)
        if cfg.fault == "async_cachegen":
            cfg = replace(cfg, router=True, async_cachegen=True)
        if cfg.async_cachegen and not cfg.router:
            cfg = replace(cfg, router=True)
        if cfg.fault == "mid_wave_evict":
            # single-shard store under real eviction pressure: waves are
            # larger than capacity so evict-after-wave vs. during-wave
            # produce different survivor sets
            cfg = replace(
                cfg,
                scenario="evict_then_hit",
                n_nodes=1,
                replication=1,
                capacity_per_node=min(cfg.capacity_per_node, 8),
                batch=max(cfg.batch, 12),
            )
        if cfg.fault == "cold_tier":
            # single-shard, exact-match, heavy eviction pressure: every
            # wave spills, immediate re-lookups promote. Exact-only keeps
            # the model's per-key promote replay aligned with the store's
            # in-wave cold stage (fuzzy would re-resolve mid-wave against
            # an index the store only updates at wave end)
            cfg = replace(
                cfg,
                scenario="evict_then_hit",
                fuzzy=False,
                n_nodes=1,
                replication=1,
                capacity_per_node=min(cfg.capacity_per_node, 8),
                batch=max(cfg.batch, 12),
                cold_tier=True,
            )
        if cfg.fault == "ttl_churn":
            # expiry-vs-lookup races: skewed reuse gaps straddle a short
            # TTL so hot keys survive while the tail expires under
            # concurrent lookups. Exact-only: an intra-wave expiry deletes
            # a key from the store's fuzzy index between two queries of
            # the SAME wave, which the model (per-key replay) cannot
            # mirror — the exact pipeline has no such coupling
            cfg = replace(
                cfg,
                scenario="skewed_reuse",
                fuzzy=False,
                n_nodes=1,
                replication=1,
                ttl_s=cfg.ttl_s if cfg.ttl_s is not None else 0.05,
            )
        if cfg.scenario == "paraphrase_burst":
            cfg = replace(cfg, fuzzy=True)
        return cfg


@dataclass
class SimReport:
    config: SimConfig
    trace_hash: str
    steps: int
    ops_applied: int
    lookups: int
    inserts: int
    violations: List[Violation]
    store_stats: Dict[str, Any]
    router_metrics: Optional[Dict[str, Any]] = None
    interceptor: Dict[str, int] = field(default_factory=dict)
    cachegen: Optional[Dict[str, int]] = None
    trace_tail: List[Dict[str, Any]] = field(default_factory=list)
    # observability: blake2b of the canonical span stream (joins the
    # determinism contract alongside trace_hash), span count, and a
    # per-span-kind census of the run
    span_digest: str = ""
    n_spans: int = 0
    span_summary: Dict[str, int] = field(default_factory=dict)
    # tiered-memory accounting (all 0 unless cold_tier/ttl was configured)
    cold_stats: Dict[str, int] = field(default_factory=dict)
    # speculation accounting (None unless cfg.speculate)
    speculation: Optional[Dict[str, int]] = None
    # where the similarity indexes ran (run_sim's keywords, not config)
    device: str = "cpu"
    index_backend: str = "auto"

    @property
    def ok(self) -> bool:
        return not self.violations


class _FakeEngine:
    """A tier engine for router scenarios: instant plans, fault-armable."""

    def __init__(self, name: str, state: EngineFaultState):
        self.name = name
        self.state = state

    def plan(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self.state.should_timeout(self.name):
            raise TimeoutError(f"{self.name}: injected engine timeout")
        return {"plan": f"{self.name}:{req['kw']}"}


class _RecordingStore:
    """Forwarding proxy over the store under test that records every
    ``insert_batch`` wave. The router (sync OR async cachegen) distills
    misses through this seam, so the harness can mirror each admission
    wave into the sequential model at the exact step it actually lands —
    which is precisely what makes the async admission race checkable."""

    def __init__(self, store: DistributedPlanCache):
        self._store = store
        # (wave, unless_written_since token, kind) — the token travels
        # with the wave so the model's conditional-admission replay sees
        # exactly the timestamp each shard compared against; kind
        # separates distilled miss waves ("distill", owed by the
        # cachegen_loss account) from committed speculation promotions
        # ("spec", owed by the spec_leak account)
        self._waves: List[
            Tuple[List[Tuple[str, Any]], Optional[float], str]
        ] = []

    def insert_batch(self, items, **kw):
        items = list(items)
        self._waves.append((items, kw.get("unless_written_since"), "distill"))
        return self._store.insert_batch(items, **kw)

    def insert(self, keyword, value, *, context=None, vector=None,
               unless_written_since=None):
        """Single-key admission — the router's committed-speculation
        promotion path. Recorded like a wave (the model must mirror it at
        the step it lands) but tagged ``spec`` so the distillation ledger
        doesn't count it as an owed miss wave."""
        self._waves.append(([(keyword, value)], unless_written_since, "spec"))
        return self._store.insert(
            keyword, value, context=context, vector=vector,
            unless_written_since=unless_written_since,
        )

    def drain_waves(
        self,
    ) -> List[Tuple[List[Tuple[str, Any]], Optional[float], str]]:
        waves, self._waves = self._waves, []
        return waves

    def __getattr__(self, name: str) -> Any:
        return getattr(self._store, name)


def run_sim(config: SimConfig, *, device=None,
            index_backend: Optional[str] = None) -> SimReport:
    cfg = config.normalized()
    dev = resolve_device(device)
    if index_backend is None:
        index_backend = "device" if dev.type == "cuda" else "auto"
    # the cold tier is REAL on-disk state (CheckpointStore segments): each
    # universe gets a throwaway directory whose path never reaches the
    # trace/span streams, so determinism digests stay machine-independent
    cold_dir = tempfile.mkdtemp(prefix="sim-cold-") if cfg.cold_tier else None
    try:
        return _run_sim(cfg, cold_dir, dev, index_backend)
    finally:
        if cold_dir is not None:
            shutil.rmtree(cold_dir, ignore_errors=True)


def _run_sim(cfg: SimConfig, cold_dir: Optional[str], device,
             index_backend: str) -> SimReport:
    if cfg.scenario not in SIM_SCENARIOS:
        raise ValueError(f"unknown scenario {cfg.scenario!r}")
    if cfg.fault not in FAULT_PLANS:
        raise ValueError(f"unknown fault plan {cfg.fault!r}")

    clock = VirtualClock()
    scheduler = StepScheduler(cfg.seed, clock)
    trace = TraceRecorder()
    violations: List[Violation] = []
    engine_faults = EngineFaultState()

    unknown = set(cfg.ablate) - set(ALL_ABLATIONS)
    if unknown:
        raise ValueError(
            f"unknown ablation key(s) {sorted(unknown)}; "
            f"valid: {list(ALL_ABLATIONS)}"
        )

    # spans bind to the virtual clock: ids are sequential, timestamps are
    # scheduler-owned, so the exported stream is byte-identical per seed
    span_exporter = InMemoryExporter()
    tracer = Tracer(clock=clock, exporters=[span_exporter])

    interceptor = SimInterceptor(scheduler, clock)
    store = DistributedPlanCache(
        cfg.n_nodes,
        replication=cfg.replication,
        capacity_per_node=cfg.capacity_per_node,
        fuzzy=cfg.fuzzy,
        fuzzy_threshold=cfg.fuzzy_threshold,
        index_backend=index_backend,
        device=device,
        eviction=cfg.eviction,
        clock=clock,
        interceptor=interceptor,
        ack_policy="primary" if "replica_ack" in cfg.ablate else "all",
        ablate=[a for a in cfg.ablate if a in _STORE_ABLATIONS],
        ttl_s=cfg.ttl_s,
        cold_dir=cold_dir,
        # tiny rotation horizon so the ablated (age-based) gc actually
        # deletes still-referenced segments within a short run — under the
        # refcount guard the same horizon never touches a live segment
        cold_keep_last=2,
    )
    interceptor.lag_steps = cfg.lag_steps

    model = ModelStore(
        replication=cfg.replication,
        capacity_per_node=cfg.capacity_per_node,
        eviction=cfg.eviction,
        exact_only=not cfg.fuzzy,
        fuzzy=cfg.fuzzy,
        fuzzy_threshold=cfg.fuzzy_threshold,
        index_backend=index_backend,
        device=device,
        clock=clock,
        # the model ALWAYS encodes the spec — an ablated store diverges
        # from it, which is exactly what the audit cells assert
        ttl_s=cfg.ttl_s,
        cold_enabled=cfg.cold_tier,
    )
    for name in list(store.shards):
        model.add_node(name)

    # the worker clients must exist before client traffic is added so the
    # scheduler's seeded choice set is stable in both router modes
    cachegen_pool: Optional[SimCachegenPool] = None
    if cfg.router and cfg.async_cachegen:
        cachegen_pool = SimCachegenPool(
            scheduler, clock, workers=cfg.cachegen_workers
        )

    # speculation side-state: the env-effect surface (a Workspace written
    # through the journal, one unique key per speculation) and the
    # verifier's own ledger of verdicts — the ground truth the spec_leak
    # oracle settles the workspace, store, and metrics against
    spec_ws = Workspace()
    spec_ledger: List[Dict[str, Any]] = []
    spec_seq = {"n": 0}

    def spec_effect(request: Dict[str, Any], kw: str):
        """Apply one speculation's eager env write; return its undo. The
        unique workspace key rides on the request so the verify call (same
        request object) can correlate verdict with effect."""
        spec_seq["n"] += 1
        ws_key = f"spec/{spec_seq['n']:04d}/{kw}"
        request["spec_ws_key"] = ws_key
        return spec_ws.write(ws_key, kw)

    def spec_verify(request: Dict[str, Any], matched_key) -> bool:
        """The background verifier: seeded ~70% agreement, deterministic
        per speculation (the workspace key is assigned in begin order,
        which the scheduler owns)."""
        agree = det_rng(
            cfg.seed, "spec-verify", request["spec_ws_key"]
        ).random() < 0.7
        spec_ledger.append({
            "kw": request["kw"], "ws_key": request["spec_ws_key"],
            "agree": agree,
        })
        return agree

    router: Optional[TwoTierRouter] = None
    rec: Optional[_RecordingStore] = None
    if cfg.router:
        rec = _RecordingStore(store)
        large = TierPool(
            "large",
            replicas=[_FakeEngine("large-0", engine_faults),
                      _FakeEngine("large-1", engine_faults)],
            hedge_timeout_s=5.0,
            hedge_failover="hedge_failover" not in cfg.ablate,
        )
        small = TierPool(
            "small", replicas=[_FakeEngine("small-0", engine_faults)]
        )
        router = TwoTierRouter(
            rec,
            extract_keyword=lambda r: r["kw"],
            plan_large=lambda r: large.dispatch(
                lambda eng: eng.plan(r), hedge=True
            ),
            plan_small_with_template=lambda r, tpl: {
                "plan": f"small:{r['kw']}", "tpl": tpl
            },
            make_template=lambda r, res: make_value(r["kw"], 0),
            # async: the sim pool's workers are scheduler clients, so the
            # seeded scheduler owns the admission-race interleavings; sync:
            # the wave lands inside the route op itself
            async_cachegen=cfg.async_cachegen,
            cachegen_pool=cachegen_pool,
            cachegen_fallback="cachegen_fallback" not in cfg.ablate,
            clock=clock,
            obs=store.obs,
            # speculative near-hit execution: verify tasks ride the same
            # sim pool, so the seeded scheduler owns the commit/rollback
            # races too. Both guards are ablatable.
            spec_verify=spec_verify if cfg.speculate else None,
            spec_effect=spec_effect if cfg.speculate else None,
            spec_rollback="spec_rollback" not in cfg.ablate,
            spec_verify_fallback="spec_verify_timeout" not in cfg.ablate,
        )

    versions: Dict[str, int] = {}
    counters = {"ops": 0, "lookups": 0, "inserts": 0}
    distill = {"expected": 0, "landed": 0}
    spec_landed = {"waves": 0, "stale_races": 0}

    def mirror_recorded_waves() -> None:
        """Replay the router's recorded admission waves on the model at
        the step they landed (sync: inside the route op; async: inside the
        cachegen worker op the scheduler chose to run). Committed
        speculation promotions mirror the same way but settle against the
        speculation ledger, not the miss-distillation account."""
        for wave, token, kind in rec.drain_waves():
            for kw, _ in wave:
                versions.setdefault(kw, 0)
            if kind == "spec" and token is not None:
                # the nastiest race made observable: a committed
                # speculation whose cached source entry was (re)written
                # after the route-time token — conditional admission must
                # lose to the newer write on that owner (the model
                # replays the same per-node skip, so a store that
                # clobbered would diverge into linearizability red)
                for kw, _ in wave:
                    if any(
                        kw in model.nodes[n]
                        and model.wtime[n][kw] >= token
                        for n in model._live_owners(kw)
                        if n not in model.crashed
                    ):
                        spec_landed["stale_races"] += 1
            model.insert_wave(wave, unless_written_since=token)
            counters["inserts"] += len(wave)
            if kind == "spec":
                spec_landed["waves"] += len(wave)
            else:
                distill["landed"] += len(wave)

    # ---- op application ----------------------------------------------------

    def check_lookup(step: int, kws: List[str], got: List[Optional[Any]]) -> None:
        # wave-level replay: the model mirrors the store's stage structure
        # (hot pass for every query, then the cold pass), not key-by-key
        for kw, real, (expected, strict) in zip(kws, got, model.lookup_wave(kws)):
            if real is not None and value_torn(real):
                violations.append(Violation(step, "torn_entry",
                                            f"{kw!r} -> corrupt value {real!r}"))
                continue
            if expected is not None and real is None:
                violations.append(Violation(
                    step, "durability",
                    f"{kw!r} acked as {expected['k']!r} v{expected['v']} "
                    "but came back MISS"))
            elif expected is not None and real is not None:
                if real.get("k") != expected["k"]:
                    violations.append(Violation(
                        step, "resolution",
                        f"{kw!r} resolved to {real.get('k')!r}, model "
                        f"resolves to {expected['k']!r}"))
                elif real.get("v") != expected["v"]:
                    violations.append(Violation(
                        step, "linearizability",
                        f"{kw!r} stale read: got v{real.get('v')}, "
                        f"acked v{expected['v']}"))
            elif expected is None and strict and real is not None:
                violations.append(Violation(
                    step, "phantom",
                    f"{kw!r} returned {real!r} but model says absent "
                    "(eviction/removal not honored)"))

    def apply_store_op(step: int, client: str, op: Dict[str, Any]) -> None:
        kind = op["op"]
        if kind == "lookup":
            got = store.lookup_batch(op["kws"])
            counters["lookups"] += len(op["kws"])
            check_lookup(step, op["kws"], got)
            trace.record(step, client, "lookup", op["kws"],
                         [None if v is None else v.get("v") for v in got])
        elif kind == "insert":
            items = []
            for kw in op["kws"]:
                versions[kw] = versions.get(kw, 0) + 1
                items.append((kw, make_value(kw, versions[kw])))
            store.insert_batch(items)
            model.insert_wave(items)
            counters["inserts"] += len(items)
            trace.record(step, client, "insert",
                         [(kw, v["v"]) for kw, v in items])
        elif kind == "remove":
            removed = store.remove(op["kw"])
            model.remove(op["kw"])
            trace.record(step, client, "remove", op["kw"], removed)
        elif kind == "autotune":
            actions = store.autotune()
            trace.record(step, client, "autotune", None, actions)
        elif kind == "keys":
            # control-plane scan: pays one seam RPC per reachable shard
            got = store.keys()
            want = model.visible_keys()
            if got != want:
                diff = sorted(set(got) ^ set(want))
                violations.append(Violation(
                    step, "control_plane",
                    f"keys() saw {len(got)} keys, model says {len(want)} "
                    f"(diff {diff[:4]}...)"))
            trace.record(step, client, "keys", None, len(got))
        elif kind == "len":
            got = len(store)
            want = len(model.visible_keys())
            if got != want:
                violations.append(Violation(
                    step, "control_plane",
                    f"len() == {got}, model says {want}"))
            trace.record(step, client, "len", None, got)
        else:
            raise ValueError(f"unknown sim op {kind!r}")

    def apply_router_op(step: int, client: str, op: Dict[str, Any]) -> None:
        kws = op["kws"] if "kws" in op else [op.get("kw", "")]
        reqs = [{"kw": kw} for kw in kws]
        counters["lookups"] += len(reqs)
        try:
            out = router.route_batch(reqs)
        except Exception as e:  # dropped wave: completeness oracle fires
            violations.append(Violation(
                step, "completeness",
                f"route_batch dropped {len(reqs)} request(s): {e!r}"))
            trace.record(step, client, "route", kws, f"ERROR:{type(e).__name__}")
            return
        for kw, res in zip(kws, out):
            if res is None:
                violations.append(Violation(
                    step, "completeness", f"request {kw!r} got no response"))
        # every large-tier miss owes the cache exactly one distilled
        # template (make_template above never returns None); the
        # cachegen_loss oracle settles the account at quiescence
        distill["expected"] += sum(
            1 for res in out
            if res is not None and res["plan"].startswith("large")
        )
        # sync mode (and the guarded saturated-pool fallback) lands the
        # wave inside this op; async waves land in a cachegen worker op
        mirror_recorded_waves()
        # record the TIER only: which hedged replica won a two-success race
        # is real concurrency the sim tolerates; the tier (and everything
        # downstream of it) must be deterministic
        trace.record(step, client, "route", kws,
                     [None if r is None
                      else ("small" if r["plan"].startswith("small") else "large")
                      for r in out])

    def apply_cachegen_op(step: int, client: str, op: Dict[str, Any]) -> None:
        try:
            items = op["fn"]()
        except Exception as e:
            op["future"].set_result(None)
            violations.append(Violation(
                step, "cachegen_error",
                f"async cache generation raised {e!r}"))
            trace.record(step, client, "cachegen", None,
                         f"ERROR:{type(e).__name__}")
            return
        op["future"].set_result(items)
        mirror_recorded_waves()
        if isinstance(items, str):
            # a speculation verify task (rides the same pool): the result
            # is its outcome, and any committed promotion wave was just
            # mirrored above at this exact step
            trace.record(step, client, "spec_verify", None, items)
            return
        trace.record(step, client, "cachegen",
                     [kw for kw, _ in (items or [])], len(items or []))

    def on_op(step: int, client: str, op: Dict[str, Any]) -> None:
        counters["ops"] += 1
        if op["op"] == "cachegen":
            apply_cachegen_op(step, client, op)
        elif router is not None and op["op"] in ("lookup", "insert"):
            apply_router_op(step, client, op)
        else:
            apply_store_op(step, client, op)

    # ---- fault firing ------------------------------------------------------

    def on_fault(step: int, spec) -> None:
        d = spec.details
        if spec.kind == "crash":
            interceptor.crash(d["node"])
            model.crash(d["node"])
        elif spec.kind == "restart":
            interceptor.restore(d["node"])
            repaired = store.restart_node(d["node"], recover=d.get("recover", True))
            model.restart(d["node"], recover=d.get("recover", True))
            trace.record(step, "fault", "restart",
                         d["node"], {"repaired": repaired})
            return
        elif spec.kind == "lag":
            interceptor.lag_steps = d["steps"]
        elif spec.kind == "hedge_timeout":
            engine_faults.arm(d["engine"], d["calls"])
        elif spec.kind == "join":
            # elastic scale-out: the facade rebalances (unless the
            # churn_rehome guard is ablated); the model mirrors the ring
            # change with the CORRECT re-home semantics
            store.add_node(d["node"])
            model.join(d["node"])
        elif spec.kind == "drain":
            store.remove_node(d["node"])
            model.drain(d["node"])
        elif spec.kind == "pool_saturate":
            if cachegen_pool is not None:
                cachegen_pool.arm_saturation(d["calls"])
        elif spec.kind == "cold_crash":
            # arm BOTH sides: the store's next spill wave dies between
            # segment write and manifest commit; the model drops the same
            # wave, so the loss is deterministic and the oracles prove it
            # is whole-wave (nothing both lost and unevicted)
            store.arm_cold_crash(d["calls"])
            model.arm_cold_crash(d["calls"])
        trace.record(step, "fault", spec.kind, d)

    # ---- run ---------------------------------------------------------------

    for ci, ops in enumerate(
        sim_traffic(cfg.scenario, cfg.seed, n_ops=cfg.n_ops,
                    n_clients=cfg.n_clients, batch=cfg.batch)
    ):
        scheduler.add_client(f"client-{ci}", ops)

    faults = build_fault_schedule(
        cfg.fault, cfg.n_ops * cfg.n_clients, lag_steps=cfg.lag_steps
    )
    with use_tracer(tracer):
        steps = scheduler.run(on_op, faults=faults, on_fault=on_fault)

        # drain inside the traced region so late cachegen spans land in the
        # exported stream before the digest is taken
        if router is not None:
            router.drain()
    tracer.close()

    # ---- terminal oracles --------------------------------------------------

    if router is not None:
        m = router.metrics
        dropped = any(v.oracle == "completeness" for v in violations)
        if m.hits + m.misses != m.requests and not dropped:
            violations.append(Violation(
                steps, "stats_conservation",
                f"router hits+misses={m.hits + m.misses} != requests={m.requests}"))
        if distill["landed"] != distill["expected"]:
            violations.append(Violation(
                steps, "cachegen_loss",
                f"{distill['expected']} miss distillation(s) owed, "
                f"{distill['landed']} landed — admission waves were "
                "dropped"))
    if cfg.speculate and router is not None and router.speculator is not None:
        spec = router.speculator
        m = router.metrics
        agrees = sum(1 for e in spec_ledger if e["agree"])
        # spec_leak: a speculation the verifier REJECTED must leave no
        # side effect behind — its journaled env write compensated, its
        # deferred cache promotion and metric bump never run. The dual
        # obligation holds too: a committed speculation's effect must
        # survive (the journal must not undo finalized steps).
        for e in spec_ledger:
            present = e["ws_key"] in spec_ws
            if e["agree"] and not present:
                violations.append(Violation(
                    steps, "spec_leak",
                    f"committed speculation on {e['kw']!r} LOST its env "
                    f"write {e['ws_key']!r} (journal undid a finalized "
                    "step)"))
            elif not e["agree"] and present:
                violations.append(Violation(
                    steps, "spec_leak",
                    f"rolled-back speculation on {e['kw']!r} leaked env "
                    f"write {e['ws_key']!r} into the workspace"))
        if m.spec_commits != agrees:
            violations.append(Violation(
                steps, "spec_leak",
                f"metrics registry saw {m.spec_commits} speculation "
                f"commit(s) but the verifier agreed {agrees} time(s) — "
                "a rolled-back speculation leaked into the metrics"))
        # still-pending speculations legitimately hold their (unresolved)
        # keys — they are spec_liveness's business, not a leak
        if (spec_ws.writes != spec.begun
                or len(spec_ws) != agrees + spec.pending()):
            violations.append(Violation(
                steps, "spec_leak",
                f"workspace holds {len(spec_ws)} key(s) after "
                f"{spec_ws.writes} speculative write(s); exactly "
                f"{agrees} committed + {spec.pending()} pending key(s) "
                "may remain"))
        # spec_liveness: every speculation begun must be resolved by
        # quiescence — a dropped verify task (the ablated fallback) or a
        # lost pool submission leaves the journal open forever
        if spec.pending() != 0:
            violations.append(Violation(
                steps, "spec_liveness",
                f"{spec.pending()} speculation(s) never resolved: "
                f"{spec.pending_keys()[:4]}"))
        resolved = spec.commits + spec.rollbacks + spec.forced_commits
        if spec.begun != resolved + spec.pending():
            violations.append(Violation(
                steps, "spec_liveness",
                f"speculation conservation broken: begun={spec.begun} != "
                f"resolved={resolved} + pending={spec.pending()}"))
    s = store.stats
    if s.hits + s.misses != counters["lookups"]:
        violations.append(Violation(
            steps, "stats_conservation",
            f"store hits+misses={s.hits + s.misses} != "
            f"lookups issued={counters['lookups']}"))
    for name, shard in sorted(store.shards.items()):
        if len(shard) > cfg.capacity_per_node:
            violations.append(Violation(
                steps, "capacity",
                f"{name} holds {len(shard)} > capacity {cfg.capacity_per_node}"))
    if not cfg.router and cfg.fault in ("none", "mid_wave_evict",
                                        "cold_tier", "ttl_churn"):
        # eviction conservation: the store must evict exactly the victims
        # the sequential policy replay evicts. Runs on fuzzy cells too —
        # the model mirrors the store's grouped per-shard per-tier
        # intra-wave touch order (see oracle.lookup_wave) — but not on
        # crash plans (a shard restart resets shard counters) or router
        # cells (route lookups touch recency the model never sees; only
        # admission waves are mirrored there)
        shard_evictions = sum(sh.stats.evictions for sh in store.shards.values())
        if shard_evictions != model.evictions:
            violations.append(Violation(
                steps, "eviction_order",
                f"store evicted {shard_evictions} entries, policy replay "
                f"says {model.evictions}"))
    if cfg.fault == "none" and not cfg.ablate:
        if store.keys() != model.keys():
            violations.append(Violation(
                steps, "linearizability",
                "final key set diverges from the sequential model"))

    if router is not None:
        router.close()

    span_summary: Dict[str, int] = {}
    for sp in span_exporter.spans:
        span_summary[sp["name"]] = span_summary.get(sp["name"], 0) + 1

    return SimReport(
        config=cfg,
        trace_hash=trace.trace_hash,
        steps=steps,
        ops_applied=counters["ops"],
        lookups=counters["lookups"],
        inserts=counters["inserts"],
        violations=violations,
        store_stats=s.snapshot(),
        router_metrics=(router.metrics.snapshot() if router is not None else None),
        interceptor={
            "calls": interceptor.calls,
            "failed_calls": interceptor.failed_calls,
            "deferred_writes": interceptor.deferred_writes,
        },
        cachegen=(
            None if cachegen_pool is None else {
                "submitted": cachegen_pool.submitted,
                "rejected": cachegen_pool.rejected,
            }
        ),
        trace_tail=trace.tail,
        span_digest=span_exporter.digest(),
        n_spans=tracer.n_spans,
        span_summary=span_summary,
        # spill/promote accounting lands on the shard-labeled counters
        # (spills happen inside shard insert waves), so aggregate those
        cold_stats={
            k: sum(sh.stats.cold_snapshot()[k]
                   for sh in store.shards.values())
            for k in s.cold_snapshot()
        },
        speculation=(
            None
            if router is None or router.speculator is None
            else {
                **router.speculator.stats(),
                "verifier_agreed": sum(1 for e in spec_ledger if e["agree"]),
                "landed": spec_landed["waves"],
                "stale_admit_races": spec_landed["stale_races"],
                "ws_writes": spec_ws.writes,
                "ws_compensations": spec_ws.compensations_run,
                "ws_keys": len(spec_ws),
            }
        ),
        device=str(device),
        index_backend=index_backend,
    )


# re-export for CLI/tests convenience
__all__ = ["ABLATION_OF", "ALL_ABLATIONS", "FAULT_PLANS",
           "SCENARIO_ABLATION_OF", "SimConfig", "SimReport", "run_sim"]
