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
    """The simulation's options are not ported yet: each raises instead of
    being ignored (the cold tier's options are ported:
    tests/test_torch_tiered.py)."""
    for kw in ({"ablate": ("fuzzy_scatter",)}, {"ablate": ("cold_gc_refcount",)}):
        with pytest.raises(TypeError, match="not ported"):
            tdc.DistributedPlanCache(n_nodes=1, **kw)
    with pytest.raises(ValueError, match="primary"):
        tdc.DistributedPlanCache(n_nodes=1, ack_policy="primary")


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

    # engine.generate spans come from the card's engines; stand-in spans
    # under each route exercise the check here
    spans = list(tspans)
    nxt = max(s["span_id"] for s in spans) + 1
    for s in tspans:
        if s["name"] == "router.route_batch":
            spans.append({"name": "engine.generate", "span_id": nxt, "parent_id": s["span_id"],
                          "start": s["start"], "end": s["end"], "attrs": {}, "events": []})
            nxt += 1
    counts, chains, routed = chip_smoke.check_span_forest(spans, tnames.SPAN_NAMES,
                                                          tnames.EVENT_NAMES)
    assert chains > 0 and routed == 12 and counts["index.topk"] == chip_smoke.DCACHE_TOPK_CALLS
    with pytest.raises(AssertionError, match="engine.generate"):
        chip_smoke.check_span_forest(tspans, tnames.SPAN_NAMES, tnames.EVENT_NAMES)
    bad = [dict(tspans[0], name="not.a.span")] + tspans[1:]
    with pytest.raises(AssertionError, match="catalog"):
        chip_smoke.check_span_forest(bad, tnames.SPAN_NAMES, tnames.EVENT_NAMES)
