"""The port's observability spine (``repro_torch.obs``) against
``repro.obs``: the name catalogs, the metrics registry and its histograms,
spans, attribution and the exporters on the same op streams, the views over
the registry (``CacheStats``, ``LSHTelemetry``, ``DeviceBank``), and the
traced quickstart ``python -m repro_torch.obs``, whose artifacts
``tools/check_trace.py`` must accept."""

import json
import os
import random
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.obs import names as jnames  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import names as tnames  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TIMED = ("lookup_time_s", "lookup_s", "lookup_latency_s")  # perf_counter readings


class TickClock:
    """A virtual clock: every read advances it by one tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _untimed(snapshot):
    """A registry snapshot without the series that hold wall-clock times."""
    return {k: v for k, v in snapshot.items() if not k.endswith(TIMED)}


def test_name_catalogs_equal_reference():
    """names.py is a verbatim copy: every constant and catalog tuple equal."""
    consts = {n for n in dir(jnames) if n.isupper()}
    assert consts == {n for n in dir(tnames) if n.isupper()}
    for n in consts:
        assert getattr(tnames, n) == getattr(jnames, n), n
    with open(os.path.join(ROOT, "src/repro/obs/names.py")) as f, \
            open(os.path.join(ROOT, "src/repro_torch/obs/names.py")) as g:
        assert f.read() == g.read()


def test_bucket_bounds_equal_reference():
    assert tobs.latency_buckets() == jobs.latency_buckets()
    assert tobs.pow2_buckets(32) == jobs.pow2_buckets(32)
    assert tobs.registry.DEFAULT_LATENCY_BUCKETS == jobs.registry.DEFAULT_LATENCY_BUCKETS


def _registry_ops(reg, seed):
    """A seeded stream of counter/gauge/histogram ops over a few labelled
    series; returns what the reads gave along the way."""
    rng = random.Random(seed)
    reads = []
    shards = ["cache-0", "cache-1", "cache-2"]
    for _ in range(400):
        op = rng.random()
        labels = {"shard": rng.choice(shards)} if rng.random() < 0.7 else {}
        if op < 0.35:
            c = reg.counter(rng.choice(["cache.hits", "cache.misses"]), **labels)
            c.inc(rng.choice([1, 2, 0.5]))
            reads.append(c.value)
        elif op < 0.5:
            g = reg.gauge("index.device.capacity", **labels)
            g.set(rng.randrange(64, 1024)) if rng.random() < 0.5 else g.dec(3)
            reads.append(g.value)
        elif op < 0.8:
            h = reg.histogram("router.lookup_latency_s", **labels)
            h.observe(10 ** rng.uniform(-7, 2.5))
            reads.append((h.count, round(h.sum, 9), h.percentile(50), h.percentile(99)))
        elif op < 0.95:
            h = reg.histogram("index.lsh.candidates", bounds=jobs.pow2_buckets(32), **labels)
            h.observe(rng.randrange(0, 5000))
            reads.append(h.percentile(90))
        elif op < 0.98:
            reg.counter("cache.hits", **labels).reset()
        else:
            reads.append(reg.names())
    return reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_op_streams_match_reference(seed):
    """The same op stream on both registries: equal reads, equal snapshots
    (sorted, byte-stable JSON), equal kind errors."""
    j, t = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    assert _registry_ops(t, seed) == _registry_ops(j, seed)
    assert t.snapshot() == j.snapshot()
    assert json.dumps(t.snapshot(), sort_keys=True) == json.dumps(j.snapshot(), sort_keys=True)
    for reg in (j, t):
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("cache.hits")
    t.reset(), j.reset()
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("values", [[], [0.5], [3.0] * 7, list(np.geomspace(1e-6, 100, 257))])
def test_histogram_percentiles_match_reference(values):
    hj, ht = jobs.Histogram("h"), tobs.Histogram("h")
    for v in values:
        hj.observe(v), ht.observe(v)
    assert ht.snapshot() == hj.snapshot()
    for q in (0, 1, 50, 90, 99, 100):
        assert ht.percentile(q) == hj.percentile(q)
    with pytest.raises(ValueError):
        tobs.Histogram("bad", bounds=(2.0, 1.0))


def _span_program(obs, exporters):
    """Nested spans, events, explicit-parent spans and an error, on a tick
    clock; returns the tracer."""
    tracer = obs.Tracer(clock=TickClock(), exporters=exporters)
    with obs.use_tracer(tracer):
        with obs.trace_span("router.route_batch", batch=3) as root:
            root.event("cache.attribution", i=0, hit=True, tokens_saved=12)
            with obs.trace_span("dcache.lookup_batch", n=3):
                with obs.trace_span("dcache.tier", tier=0) as tier:
                    tier.set(shards=2)
                    obs.current_span().event("spec.fate", fate="commit", kw="k")
            late = tracer.start_span("router.cachegen", parent=root, n=2)
        late.end()
        late.end()  # idempotent
        with pytest.raises(KeyError):
            with obs.trace_span("cache.lookup_batch"):
                raise KeyError("x")
        orphan = tracer.start_span("router.spec_verify", parent=obs.NOOP_SPAN)
        orphan.end()
    assert obs.get_tracer() is obs.NOOP_TRACER
    assert obs.trace_span("router.route") is obs.NOOP_SPAN  # tracing off: no-op
    tracer.close()
    return tracer


def test_spans_and_exporters_match_reference(tmp_path):
    """The same span program on a tick clock exports byte-identical JSONL
    and Chrome traces, and equal digests."""
    out = {}
    for side, obs in (("j", jobs), ("t", tobs)):
        mem = obs.InMemoryExporter()
        path = tmp_path / f"{side}.jsonl"
        tracer = _span_program(obs, [mem, obs.JsonlExporter(str(path))])
        chrome = tmp_path / f"{side}_chrome.json"
        obs.write_chrome_trace(str(chrome), mem.spans)
        out[side] = (tracer.n_spans, mem.lines(), mem.digest(), path.read_bytes(),
                     chrome.read_bytes())
    assert out["t"] == out["j"]
    assert out["t"][0] == 6
    spans = [json.loads(line) for line in out["t"][1]]
    assert [s["attrs"].get("error") for s in spans if s["name"] == "cache.lookup_batch"] == [
        "KeyError"]


def test_a_span_on_the_profiler_clock_contains_its_profiled_block():
    """A span on ``profiler_clock`` and the profiler's event for the block
    inside it share a timebase: the span holds the block's interval (to the
    clock's ~0.24 us resolution). A span on the default perf counter is on
    another clock altogether."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mem = tobs.InMemoryExporter()
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tobs.use_tracer(tobs.Tracer(clock=tobs.profiler_clock, exporters=[mem])):
            with tobs.trace_span("engine.decode_step", step=0, active=1):
                with record_function("timed-block"):
                    (x @ x).sum()
        with tobs.use_tracer(tobs.Tracer(exporters=[mem])):
            with tobs.trace_span("engine.decode_step", step=1, active=1):
                pass
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "timed-block"]
    on_profiler, on_perf = mem.spans
    assert ev.duration_ns() > 0
    assert on_profiler["start"] * 1e9 - 1e3 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= on_profiler["end"] * 1e9 + 1e3
    assert abs(on_perf["start"] * 1e9 - ev.start_ns()) > 1e9


def test_attribution_matches_reference():
    """Nested collectors shadow, deposits merge, and no collector is a
    no-op; the §4.4 estimate agrees on templates with and without
    ``size_tokens``."""
    from repro.core.template import PlanStep as JStep
    from repro.core.template import PlanTemplate as JTemplate
    from repro_torch.core.template import PlanStep, PlanTemplate

    got = {}
    for side, obs in (("j", jobs), ("t", tobs)):
        obs.deposit(0, stage="exact")  # no collector: dropped
        with obs.collect() as outer:
            obs.deposit(0, stage="fuzzy", matched_key="a")
            with obs.collect() as inner:
                obs.deposit(1, stage="exact")
            obs.deposit(2, node="cache-1", **inner.get(1))
            obs.deposit(0, replica_tier=1)
        got[side] = (dict(outer.items()), dict(inner.items()), outer.get(7))
    assert got["t"] == got["j"]
    steps = [("message", "retrieve revenue and net income"), ("answer", "{a} / {b}")]
    for tpl_t, tpl_j in ((PlanTemplate("kw", [PlanStep(*s) for s in steps], "q"),
                          JTemplate("kw", [JStep(*s) for s in steps], "q")),
                         ({"plan": "x" * 37}, {"plan": "x" * 37}), ("", "")):
        assert tobs.tokens_saved_estimate(tpl_t) == jobs.tokens_saved_estimate(tpl_j)
    assert tobs.tokens_saved_estimate(tpl_t) == 1  # the empty string's floor


@pytest.mark.parametrize("backend", ["brute", "auto", "bucketed", "device"])
def test_cache_views_share_one_registry_like_reference(backend):
    """Two PlanCaches on one registry with shard labels, the same stream:
    equal per-shard ``cache.*`` series and ``CacheStats`` snapshots; the
    LSH and device-bank telemetry register there too. The device bank's
    upload bytes differ by the reference's padding of a wave to a power of
    two (``repro_torch.index.device``), so those series are compared only
    by name."""
    from repro.core.cache import PlanCache as JPlanCache
    from repro_torch.core.cache import PlanCache

    regs = {"j": jobs.MetricsRegistry(), "t": tobs.MetricsRegistry()}
    caches = {}
    for side, cls in (("j", JPlanCache), ("t", PlanCache)):
        kw = {"device": "cpu"} if side == "t" and backend == "device" else {}
        caches[side] = [cls(capacity=6, fuzzy=True, fuzzy_threshold=0.6, index_backend=backend,
                            obs=regs[side], obs_labels={"shard": f"cache-{n}"}, **kw)
                        for n in range(2)]
    rng = random.Random(3)
    words = ["net income growth", "fcf margin", "opex change", "liquidity runway",
             "fcf margin calculation", "opex change yoy", "receivable days", "roe"]
    for _ in range(80):
        n = rng.randrange(2)
        batch = rng.sample(words, 3)
        if rng.random() < 0.5:
            vals = [c[n].lookup_batch(batch) for c in (caches["j"], caches["t"])]
            assert vals[0] == vals[1]
        else:
            for c in (caches["j"], caches["t"]):
                c[n].insert_batch([(w, w.upper()) for w in batch])
    for n in range(2):
        sj, st = caches["j"][n].stats.snapshot(), caches["t"][n].stats.snapshot()
        sj.pop("lookup_time_s"), st.pop("lookup_time_s")
        assert st == sj
    snap_j, snap_t = _untimed(regs["j"].snapshot()), _untimed(regs["t"].snapshot())
    assert snap_t.keys() == snap_j.keys()
    for name in snap_j:
        if not name.startswith("index.device."):
            assert snap_t[name] == snap_j[name], name
    if backend == "device":
        assert snap_t["index.device.h2d_bytes_total"].keys() == snap_j[
            "index.device.h2d_bytes_total"].keys()
        tele = caches["t"][0].pipeline.stage("fuzzy").index.telemetry()
        assert tele["device"]["h2d_bytes_total"] > 0
    if backend in ("auto", "bucketed"):
        tj = caches["j"][1]._matcher.index.telemetry()
        tt = caches["t"][1].pipeline.stage("fuzzy").index.telemetry()
        assert tt == tj


def _quickstart_trace(obs, dcache_cls, router_cls, requests):
    """The quickstart's workload under synchronous cache generation on a
    tick clock: (span dicts, registry snapshot, router snapshot)."""
    registry = obs.MetricsRegistry()
    mem = obs.InMemoryExporter()
    tracer = obs.Tracer(clock=TickClock(), exporters=[mem])
    cache = dcache_cls(n_nodes=2, fuzzy=True, capacity_per_node=64, obs=registry)
    router = router_cls(
        cache, extract_keyword=lambda r: r["query"],
        plan_large=lambda r: {"plan": f"fresh plan for {r['query']}"},
        plan_small_with_template=lambda r, t: {"plan": "adapted", "from": t},
        make_template=lambda r, res: res["plan"], async_cachegen=False)
    with obs.use_tracer(tracer):
        for i in range(0, len(requests), 6):
            router.route_batch(requests[i:i + 6])
    router.close()
    return mem.spans, registry.snapshot(), router.metrics.snapshot()


def test_quickstart_span_forest_matches_reference():
    """The quickstart's workload (its own request generator) through both
    packages under synchronous cache generation: the same span-name
    multiset, the same parent structure, the same attributes and events,
    and equal metrics once timings are stripped."""
    from repro.core.distributed_cache import DistributedPlanCache as JDCache
    from repro.obs.__main__ import _requests as jrequests
    from repro.serving.router import TwoTierRouter as JRouter
    from repro_torch.core.distributed_cache import DistributedPlanCache
    from repro_torch.obs.__main__ import _requests
    from repro_torch.serving.router import TwoTierRouter

    assert _requests(24) == jrequests(24)
    sj, rj, mj = _quickstart_trace(jobs, JDCache, JRouter, jrequests(24))
    st, rt, mt = _quickstart_trace(tobs, DistributedPlanCache, TwoTierRouter, _requests(24))
    assert sorted(s["name"] for s in st) == sorted(s["name"] for s in sj)

    def shape(spans):
        by_id = {s["span_id"]: s for s in spans}
        return [(s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None,
                 s["attrs"], s["events"]) for s in spans]

    assert shape(st) == shape(sj)
    assert _untimed(rt) == _untimed(rj)
    for m in (mj, mt):
        m.pop("lookup_s"), m.pop("lookup_latency")
    assert mt == mj and mt["hit_rate"] == 0.75 and mt["tokens_saved"] == 150


def test_quickstart_cli_artifacts_pass_check_trace(tmp_path):
    """``python -m repro_torch.obs`` writes the three artifacts, and
    ``tools/check_trace.py`` (the reference's catalog, read by AST) accepts
    them; metrics.json holds the reference quickstart's series."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--out-dir", str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "routed 24 requests  hit_rate=0.75  tokens_saved=150" in out.stdout
    chk = subprocess.run([sys.executable, "tools/check_trace.py", "--dir", str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    assert chk.stdout.startswith("trace OK")
    with open(tmp_path / "metrics.json") as f:
        metrics = json.load(f)
    assert set(metrics) <= set(tnames.METRIC_NAMES)
    assert metrics["router.requests"] == {"": 24}
    assert set(metrics["cache.hits"]) == {"", "shard=cache-0", "shard=cache-1"}
