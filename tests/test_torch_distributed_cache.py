"""The port's ``DistributedPlanCache`` against ``repro``'s: the hash ring,
op streams in lockstep (membership, replication, the fuzzy scatter, an
interceptor that raises ``ShardUnavailable``, ``restart_node(recover=True)``,
``autotune``) on the ``brute``, ``auto`` and ``device`` backends (the port's
``device`` index on the CPU), and the traced router over it on the stream
``chip_smoke.py`` routes on the card, which gives the pins that script
holds the card's run to."""

import gc
import os
import random
import sys
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import distributed_cache as jdc  # noqa: E402
from repro.serving.router import TwoTierRouter as JRouter  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import distributed_cache as tdc  # noqa: E402
from repro_torch.obs import names as tnames  # noqa: E402
from repro_torch.obs import port_names  # noqa: E402
from repro_torch.serving.router import TwoTierRouter  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
TIMED = ("lookup_time_s", "lookup_s", "lookup_latency_s")  # perf_counter readings

WORDS = ["net income growth", "net income growth yoy", "fcf margin", "fcf margin calculation",
         "opex change", "opex change analysis", "liquidity runway", "receivable days",
         "receivable days derivation", "dupont roe decomposition", "fee income yoy change",
         "insurance float yoy change", "insurance float share of revenue"]


class Crashes:
    """An interceptor: calls to a node in ``crashed`` raise the package's
    ShardUnavailable; every call is logged as (node, op)."""

    def __init__(self, mod):
        self.mod, self.crashed, self.calls = mod, set(), []

    def call(self, node, op, fn):
        self.calls.append((node, op))
        if node in self.crashed:
            raise self.mod.ShardUnavailable(node)
        return fn()


def _untimed(snapshot):
    return {k: v for k, v in snapshot.items() if not k.endswith(TIMED)}


def test_hash_ring_owners_match_reference():
    rings = (jdc.HashRing(), tdc.HashRing())
    keys = [f"key {i}" for i in range(300)]
    for step, (op, node) in enumerate([("add", "cache-0"), ("add", "cache-1"), ("add", "cache-2"),
                                       ("add", "cache-1"), ("remove", "cache-0"),
                                       ("add", "cache-9"), ("remove", "nope")]):
        for ring in rings:
            getattr(ring, op)(node)
        assert rings[1].nodes == rings[0].nodes
        for r in (1, 2, 3):
            assert [rings[1].nodes_for(k, r) for k in keys] == [
                rings[0].nodes_for(k, r) for k in keys], (step, r)
    assert tdc._hash("cache-0#3") == jdc._hash("cache-0#3")


def _make(mod, backend, **kw):
    ic = Crashes(mod)
    extra = {"device": "cpu"} if mod is tdc and backend == "device" else {}
    cache = mod.DistributedPlanCache(n_nodes=3, replication=2, capacity_per_node=5, fuzzy=True,
                                     fuzzy_threshold=0.6, index_backend=backend, interceptor=ic,
                                     clock=iter(range(10**6)).__next__, **kw, **extra)
    return cache, ic


def _op_stream(cache, ic, seed):
    """A seeded stream of data- and control-plane ops; every result, the
    loads and the seam's call log after each op."""
    rng = random.Random(seed)
    seen = []
    for n in range(140):
        op = rng.random()
        live = sorted(cache.shards)
        if op < 0.3:
            got = cache.lookup_batch(rng.sample(WORDS, rng.randrange(1, 6)))
        elif op < 0.55:
            batch = rng.sample(WORDS, rng.randrange(1, 4))
            cache.insert_batch([(w, f"{w}@{n}") for w in batch],
                               unless_written_since=rng.choice([None, n // 2]))
            got = None
        elif op < 0.6:
            got = cache.remove(rng.choice(WORDS))
        elif op < 0.65:
            cache.add_node(f"cache-{rng.randrange(5)}")
            got = sorted(cache.shards)
        elif op < 0.68 and len(live) > 1:
            cache.remove_node(rng.choice(live))
            got = sorted(cache.shards)
        elif op < 0.74:
            cache.mark_down(rng.choice(live))
            got = sorted(cache.down)
        elif op < 0.78:
            cache.mark_up(rng.choice(live))
            got = sorted(cache.down)
        elif op < 0.86:
            got = cache.restart_node(rng.choice(live), recover=rng.random() < 0.8)
        elif op < 0.92:
            node = rng.choice(live)
            ic.crashed ^= {node}  # crash discovered at call time, or healed
            got = sorted(ic.crashed)
        elif op < 0.95:
            got = cache.autotune()
        elif op < 0.97:
            got = (cache.keys(), len(cache), [w in cache for w in WORDS])
        elif op < 0.98:
            cache.clear()
            got = None
        else:
            got = cache.lookup(rng.choice(WORDS))
        seen.append((n, got, cache.load_by_node(), list(ic.calls)))
    return seen


@pytest.mark.parametrize("backend", ["brute", "auto", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_op_streams_match_reference(backend, seed):
    """The same op stream on both facades (3 nodes, replication 2, fuzzy at
    0.6, crash-injecting interceptor): equal results, loads and shard-call
    logs after every op, equal facade and per-shard stats, and equal
    registries (timings aside; the device banks' upload bytes differ by the
    reference's power-of-two padding of a wave, and a restarted shard's
    device bank is a fresh one, so those series are compared by name)."""
    (jc, jic), (tc, tic) = _make(jdc, backend), _make(tdc, backend)
    got = _op_stream(tc, tic, seed)
    want = _op_stream(jc, jic, seed)
    for g, w in zip(got, want, strict=True):
        assert g == w, g[0]
    assert any(isinstance(g[1], int) and g[1] > 0 for g in got)  # a restart repaired entries
    assert any(g[1] is not None and any(v is not None for v in g[1])
               for g in got if isinstance(g[1], list) and g[1] and not isinstance(g[1][0], str))
    for facade in ((jc, tc),):
        sj, st = facade[0].stats.snapshot(), facade[1].stats.snapshot()
        sj.pop("lookup_time_s"), st.pop("lookup_time_s")
        assert st == sj and st["hits"] > 0
    snap_j, snap_t = _untimed(jc.obs.snapshot()), _untimed(tc.obs.snapshot())
    assert snap_t.keys() == snap_j.keys()
    for name in snap_j:
        if name.startswith("index.device."):
            assert snap_t[name].keys() == snap_j[name].keys(), name
        else:
            assert snap_t[name] == snap_j[name], name


@pytest.mark.parametrize("backend", ["brute", "auto", "bucketed"])
def test_plan_cache_repair_primitives_match_reference(backend):
    """What the distributed cache calls on its shards beyond lookups and
    inserts: ``peek`` and ``snapshot_items`` (no hit or recency
    accounting, expired entries skipped), ``to_state`` and ``autotune``,
    on one stream with TTL expiry under a settable clock."""
    from repro.core.cache import PlanCache as JPlanCache
    from repro_torch.core.cache import PlanCache

    now = [0.0]
    caches = [cls(capacity=4, fuzzy=True, fuzzy_threshold=0.6, index_backend=backend, ttl_s=5.0,
                  clock=lambda: now[0]) for cls in (JPlanCache, PlanCache)]
    rng = random.Random(7)
    for n in range(120):
        now[0] += rng.choice([0.5, 1.0, 3.0])
        w, op = rng.choice(WORDS), rng.random()
        got = []
        for c in caches:
            if op < 0.4:
                c.insert(w, n)
                got.append(None)
            elif op < 0.6:
                got.append(c.peek(w))
            elif op < 0.75:
                got.append(c.snapshot_items())
            elif op < 0.9:
                got.append(c.lookup(w))
            else:
                got.append((c.to_state(), c.autotune()))
        assert got[0] == got[1], n
        assert caches[0].stats.snapshot()["hits"] == caches[1].stats.snapshot()["hits"]
    assert caches[1].to_state()["capacity"] == 4


def test_deferred_options_raise():
    """The simulation's options are ported (``ablate=``, ``ack_policy=
    "primary"``, below); what the reference refuses, the port refuses with
    the reference's errors: an unknown ack policy, and "primary" without an
    interceptor whose ``defer`` carries the lagged replica writes."""
    for kw in ({"ack_policy": "quorum"}, {"ack_policy": "primary"},
               {"ack_policy": "primary", "interceptor": Crashes(tdc)}):
        with pytest.raises(ValueError) as port:
            tdc.DistributedPlanCache(n_nodes=1, **kw)
        if "interceptor" in kw:
            kw = {**kw, "interceptor": Crashes(jdc)}
        with pytest.raises(ValueError) as ref:
            jdc.DistributedPlanCache(n_nodes=1, **kw)
        assert str(port.value) == str(ref.value)
    # the store takes any ablation key, as the reference's does (the
    # simulation harness is what refuses unknown ones)
    for mod in (jdc, tdc):
        assert mod.DistributedPlanCache(n_nodes=1, ablate=("nope",)).ablate == {"nope"}


class Lags(Crashes):
    """``Crashes`` with the replica-lag channel: ``defer`` queues a write,
    which lands before every seventh call (a crashed node's is dropped)."""

    def __init__(self, mod):
        super().__init__(mod)
        self.queued = []

    def defer(self, node, fn):
        self.queued.append((node, fn))

    def flush(self):
        queued, self.queued = self.queued, []
        for node, fn in queued:
            if node not in self.crashed:
                fn()
        return len(queued)

    def call(self, node, op, fn):
        if len(self.calls) % 7 == 6:
            self.flush()
        return super().call(node, op, fn)


STORE_ABLATIONS = ("crash_fallthrough", "evict_after_wave", "churn_rehome", "fuzzy_scatter",
                   "cold_gc_refcount", "ttl_expiry")


@pytest.mark.parametrize("ablate", STORE_ABLATIONS + ("ack_primary",))
def test_ablation_op_streams_match_reference(ablate, tmp_path):
    """Each of the simulation's store seams switched off, on the same op
    stream in both facades (``auto`` index; a TTL for ``ttl_expiry``, a
    cold tier with a short rotation for ``cold_gc_refcount``; for
    ``ack_policy="primary"`` the lagged replica writes land before every
    seventh shard call): equal results, loads and shard-call logs after
    every op, and equal stats; the guarded store answers the same stream
    otherwise."""

    def make(mod, guarded=False):
        ic = Lags(mod)
        kw = dict(ablate=(ablate,)) if ablate != "ack_primary" else dict(ack_policy="primary")
        if guarded:
            kw = {}
        if ablate == "ttl_expiry":
            kw["ttl_s"] = 40
        if ablate == "cold_gc_refcount":
            kw.update(cold_dir=str(tmp_path / f"{mod.__name__}{guarded}"), cold_keep_last=2)
        cache = mod.DistributedPlanCache(n_nodes=3, replication=2, capacity_per_node=3,
                                         fuzzy=True, fuzzy_threshold=0.6, interceptor=ic,
                                         clock=iter(range(10**6)).__next__, **kw)
        return cache, ic

    (jc, jic), (tc, tic) = make(jdc), make(tdc)
    got, want = _op_stream(tc, tic, seed=3), _op_stream(jc, jic, seed=3)
    for g, w in zip(got, want, strict=True):
        assert g == w, g[0]
    assert tic.flush() == jic.flush()
    sj, st = jc.stats.snapshot(), tc.stats.snapshot()
    sj.pop("lookup_time_s"), st.pop("lookup_time_s")
    assert st == sj
    # and the seam bites: the guarded store answers the stream otherwise
    assert [g[:3] for g in _op_stream(*make(tdc, guarded=True), seed=3)] != [g[:3] for g in got]


def _kw_store(mod, n_nodes=4, replication=2, crashed=(), **kw):
    """tests/test_sim.py's store: ``n_nodes`` nodes of 64 slots, "kw-i" ->
    i inserted for i < 24 (30 with replication 2), ``crashed`` nodes behind
    a ``Crashes`` interceptor (the facade not told)."""
    ic = Crashes(mod)
    dc = mod.DistributedPlanCache(n_nodes, replication=replication, capacity_per_node=64,
                                  interceptor=ic, **kw)
    n = 30 if replication == 2 else 24
    for i in range(n):
        dc.insert(f"kw-{i}", i)
    ic.crashed.update(crashed)
    return dc, ic, n


def _sim_case(mod, case):
    """One of tests/test_sim.py's direct cases of the store's seams, as
    plain data: what the case asserts on."""
    if case == "crash_fallthrough":
        dc, _, n = _kw_store(mod, crashed=("cache-1",))
        return [dc.lookup(f"kw-{i}") for i in range(n)]
    if case == "crash_fallthrough_ablated":
        dc, _, n = _kw_store(mod, crashed=("cache-1",), ablate=("crash_fallthrough",))
        return [dc.lookup(f"kw-{i}") for i in range(n)]
    if case == "restart_read_repair":
        dc, _, n = _kw_store(mod)
        repaired = dc.restart_node("cache-2", recover=True)
        out = [repaired, len(dc.shards["cache-2"]), [dc.lookup(f"kw-{i}") for i in range(n)]]
        dc.mark_down("cache-0")
        return out + [[dc.lookup(f"kw-{i}") for i in range(n)]]
    if case == "restart_without_repair":
        dc, _, n = _kw_store(mod, replication=1)
        held = len(dc.shards["cache-2"])
        dc.restart_node("cache-2", recover=False)
        return [held, len(dc.shards["cache-2"]), [dc.lookup(f"kw-{i}") for i in range(n)]]
    if case == "control_plane":
        dc, ic, _ = _kw_store(mod, replication=1)
        held = len(dc.shards["cache-1"])
        ic.crashed.add("cache-1")
        out = [held, dc.keys(), len(dc), dc.autotune()]
        dc.clear()
        out.append(len(dc.shards["cache-1"]))
        ic.crashed.discard("cache-1")
        out.append(len(dc))
        dc.restart_node("cache-1", recover=False)
        return out + [len(dc), ic.calls]
    if case == "graceful_drain_unreachable":
        dc, ic, n = _kw_store(mod, replication=1)
        held = len(dc.shards["cache-1"])
        ic.crashed.add("cache-1")
        dc.remove_node("cache-1")
        ic.crashed.discard("cache-1")
        return [held, sorted(dc.shards), [dc.lookup(f"kw-{i}") for i in range(n)]]
    if case in ("churn_rehome", "churn_rehome_ablated"):
        kw = {"ablate": ("churn_rehome",)} if case.endswith("ablated") else {}
        dc, _, n = _kw_store(mod, replication=1, **kw)
        dc.add_node("cache-9")
        return [dc.lookup(f"kw-{i}") for i in range(n)]
    raise ValueError(case)


SIM_CASES = ("crash_fallthrough", "crash_fallthrough_ablated", "restart_read_repair",
             "restart_without_repair", "control_plane", "graceful_drain_unreachable",
             "churn_rehome", "churn_rehome_ablated")


@pytest.mark.parametrize("case", SIM_CASES)
def test_sim_store_cases_match_reference(case):
    """The twins of tests/test_sim.py's direct cases of the seams (crash
    fallthrough and its ablation, restart with and without read-repair, the
    control plane through the seam, draining an unreachable node, churn
    re-homing and its ablation): equal outcomes in both packages, and the
    outcome the reference's test asserts."""
    got, want = _sim_case(tdc, case), _sim_case(jdc, case)
    assert got == want
    if case in ("crash_fallthrough", "churn_rehome"):
        assert got == list(range(len(got)))  # every key served
    if case in ("crash_fallthrough_ablated", "churn_rehome_ablated"):
        assert None in got  # the ablated facade loses keys
    if case == "restart_read_repair":
        assert got[0] == got[1] and got[2] == got[3] == list(range(30))
    if case == "restart_without_repair":
        assert got[1] == 0 and got[2].count(None) == got[0] > 0
    if case == "control_plane":
        held, keys, n, actions, kept, back, after = got[:7]
        assert held > 0 and len(keys) == 24 - held == n and actions == []
        assert kept == held and back == held and after == 0
    if case == "graceful_drain_unreachable":
        assert "cache-1" not in got[1] and got[2].count(None) == got[0]


def test_restart_replaces_and_frees_the_device_bank():
    """``restart_node`` on the ``device`` backend builds the shard anew: the
    old shard's bank tensor is freed, the new one is empty and then
    read-repaired from the peer."""
    cache = tdc.DistributedPlanCache(n_nodes=2, replication=2, capacity_per_node=4, fuzzy=True,
                                     fuzzy_threshold=0.6, index_backend="device", device="cpu")
    cache.insert_batch([(w, w) for w in ("net income growth", "fcf margin", "opex change",
                                         "liquidity runway")])
    old = cache.shards["cache-1"].pipeline.stage("fuzzy").index._device
    gone = weakref.ref(old.arena)
    del old
    assert cache.restart_node("cache-1", recover=True) == 4
    gc.collect()
    assert gone() is None
    new = cache.shards["cache-1"].pipeline.stage("fuzzy").index
    assert new._device.arena.device.type == "cpu" and len(new) == 4
    assert cache.lookup_batch(["fcf margin calculation"]) == ["fcf margin"]


def _dcache_run(side):
    """chip_smoke.py's phase-7(b) stream through one package's traced router
    over its DistributedPlanCache (planners are stand-ins: no model runs)."""
    if side == "j":
        from repro.envs.workloads import get_env
        obs, dc, router_cls, kw = jobs, jdc, JRouter, {}
    else:
        from repro_torch.envs.workloads import get_env
        obs, dc, router_cls, kw = tobs, tdc, TwoTierRouter, {"device": "cpu"}
    tasks = get_env("financebench").generate(chip_smoke.N_TASKS, seed=0)
    cache = dc.DistributedPlanCache(
        n_nodes=chip_smoke.DCACHE_NODES, replication=2, fuzzy=True, fuzzy_threshold=0.6,
        index_backend="device", capacity_per_node=chip_smoke.ROUTER_CAPACITY, **kw)
    verdict = chip_smoke.dcache_verdict(tasks)
    router = router_cls(
        cache, extract_keyword=chip_smoke.dcache_keyword,
        plan_large=lambda req: {"plan": "fresh"},
        plan_small_with_template=lambda req, tpl: {"plan": "adapted"},
        make_template=lambda req, res: {"id": req[0].intent.keyword, "plan": "fresh"},
        async_cachegen=False,
        spec_verify=lambda req, key: verdict(chip_smoke.dcache_keyword(req), key))
    mem = obs.InMemoryExporter()
    with obs.use_tracer(obs.Tracer(exporters=[mem])):
        repaired = chip_smoke.drive_dcache(router, cache, chip_smoke.dcache_waves(tasks))
    router.close()
    return router, cache, mem.spans, repaired


def test_chip_smoke_dcache_stream_matches_reference():
    """The traced router over a 2-node fuzzy DistributedPlanCache on the
    `device` index, through the mark-down and the restart: the port's
    counters, cache contents and index calls equal the reference's, and
    are the pins chip_smoke.py holds the card's run to; the port's span
    forest passes chip_smoke.py's own check."""
    jr, jc, jspans, jrep = _dcache_run("j")
    tr, tc, tspans, trep = _dcache_run("t")
    assert trep[0] == jrep[0] > 0
    got = {k: getattr(tr.metrics, k) for k in chip_smoke.DCACHE_EXPECT}
    assert got == {k: getattr(jr.metrics, k) for k in chip_smoke.DCACHE_EXPECT}
    assert got == chip_smoke.DCACHE_EXPECT
    assert 0 < got["spec_rollbacks"] < got["speculations"]
    assert tc.keys() == jc.keys() and tc.load_by_node() == jc.load_by_node()
    topk = [sum(s["name"] == "index.topk" for s in spans) for spans in (jspans, tspans)]
    assert topk[0] == topk[1] == chip_smoke.DCACHE_TOPK_CALLS
    assert sorted(s["name"] for s in tspans) == sorted(s["name"] for s in jspans)

    # engine.generate spans, with the port's engine.prefill and
    # engine.decode_step inside, come from the card's engines; stand-in spans
    # under each route exercise the check here
    spans = list(tspans)
    nxt = max(s["span_id"] for s in spans) + 1
    for s in tspans:
        if s["name"] == "router.route_batch":
            gen = nxt
            for name, parent in (("engine.generate", s["span_id"]), ("engine.prefill", gen),
                                 ("engine.decode_step", gen)):
                spans.append({"name": name, "span_id": nxt, "parent_id": parent,
                              "start": s["start"], "end": s["end"], "attrs": {}, "events": []})
                nxt += 1
    catalog = tnames.SPAN_NAMES + port_names.SPAN_NAMES
    counts, chains, routed = chip_smoke.check_span_forest(spans, catalog, tnames.EVENT_NAMES)
    assert chains > 0 and routed == 12 and counts["index.topk"] == chip_smoke.DCACHE_TOPK_CALLS
    assert counts["engine.prefill"] == counts["engine.decode_step"] == 12
    with pytest.raises(AssertionError, match="engine.prefill"):
        chip_smoke.check_span_forest(spans, tnames.SPAN_NAMES, tnames.EVENT_NAMES)
    with pytest.raises(AssertionError, match="engine.generate"):
        chip_smoke.check_span_forest(tspans, tnames.SPAN_NAMES, tnames.EVENT_NAMES)
    bad = [dict(tspans[0], name="not.a.span")] + tspans[1:]
    with pytest.raises(AssertionError, match="catalog"):
        chip_smoke.check_span_forest(bad, tnames.SPAN_NAMES, tnames.EVENT_NAMES)
