"""The port's PlanCache with its match pipeline (``repro_torch.core.cache``,
``repro_torch.memory``) against ``repro.core.cache.PlanCache`` on the CPU:
the same operation streams give the same answers, counters, listener calls
and conditional-admission skips."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.cache import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.memory.pipeline import build_pipeline  # noqa: E402

torch.set_num_threads(2)


class _Clock:
    """A settable clock; each store gets its own, advanced in step."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(**kw):
    clock, jclock = _Clock(), _Clock()
    events, jevents = [], []
    t = PlanCache(clock=clock, device="cpu", **kw)
    j = JPlanCache(clock=jclock, **kw)
    t.add_evict_listener(events.append)
    j.add_evict_listener(jevents.append)
    return t, j, (clock, jclock), (events, jevents)


def _stats(c):
    s = c.stats
    return (s.hits, s.misses, s.inserts, s.evictions, s.stale_insert_skips)


@pytest.mark.parametrize("pipeline", [None, ("exact", "semantic"), ("exact", "fuzzy", "semantic")])
def test_plan_cache_stream_matches_reference(pipeline):
    """A seeded stream of single and wave inserts (with overwrites and
    conditional admission), lookup_batch calls with near-miss keywords and
    contexts, removals and evictions, on the ``device`` index backend."""
    rng = np.random.RandomState(11)
    kw = dict(capacity=12, fuzzy=True, fuzzy_threshold=0.7, semantic_threshold=0.6,
              index_backend="device")
    if pipeline is not None:
        kw["pipeline"] = pipeline
    t, j, clocks, events = _pair(**kw)
    words = ["revenue", "margin", "ratio", "growth", "debt", "cash", "capital",
             "quarterly", "annual", "net", "operating", "working"]

    def keyword():
        return " ".join(rng.choice(words, size=rng.randint(1, 4)))

    for step in range(250):
        for c in clocks:
            c.t += 1.0
        r = rng.rand()
        if r < 0.35:
            n = rng.randint(1, 5)
            items = [(keyword(), step * 10 + i) for i in range(n)]
            ctx = [f"context {rng.randint(20)} {k}" for k, _ in items]
            since = float(step - rng.randint(0, 6)) if rng.rand() < 0.3 else None
            t.insert_batch(items, contexts=ctx, unless_written_since=since)
            j.insert_batch(items, contexts=ctx, unless_written_since=since)
        elif r < 0.45:
            k, v = keyword(), step
            t.insert(k, v)
            j.insert(k, v)
        elif r < 0.9:
            probes = [keyword() + (" analysis" if rng.rand() < 0.3 else "")
                      for _ in range(rng.randint(1, 6))]
            ctx = [f"context {rng.randint(20)} {p}" for p in probes]
            assert t.lookup_batch(probes, contexts=ctx) == j.lookup_batch(probes, contexts=ctx), step
        elif r < 0.97:
            k = keyword()
            assert t.remove(k) == j.remove(k)
        else:
            k = keyword()
            assert t.lookup(k) == j.lookup(k)
        assert sorted(t.keys()) == sorted(j.keys()), step
        assert _stats(t) == _stats(j), step
    assert events[0] == events[1] and events[0]
    assert t.stats.evictions > 0 and t.stats.stale_insert_skips > 0 and t.stats.hits > 0
    assert t.now() == j.now()
    t.clear()
    j.clear()
    assert events[0] == events[1] and len(t) == 0 and _stats(t) == _stats(j)


def test_plan_cache_insert_batch_keeps_index_in_lockstep():
    """Eviction runs after the wave lands; the fuzzy index holds exactly the
    live keys, and its device arena mirrors the host arena."""
    t, j, _, _ = _pair(capacity=10, fuzzy=True, fuzzy_threshold=0.7, index_backend="device")
    for c in (t, j):
        c.insert_batch([(f"metric number {i}", i) for i in range(14)])
    assert len(t) == 10 and sorted(t.keys()) == sorted(j.keys())
    index = t.pipeline.stage("fuzzy").index
    assert sorted(index.bank.keys()) == sorted(t.keys())
    np.testing.assert_array_equal(index._device.arena.numpy()[: index.bank.high_water],
                                  index.bank.matrix())
    assert t.lookup("metric number 13") == 13
    assert t.lookup_batch(["metric number 13 analysis"]) == j.lookup_batch(
        ["metric number 13 analysis"]) == [13]


def test_overwrite_is_delete_then_insert():
    t, j, _, events = _pair(capacity=4)
    for c in (t, j):
        c.insert("alpha", 1)
        c.insert("alpha", 2)
    assert t.lookup("alpha") == j.lookup("alpha") == 2
    assert events[0] == events[1] == ["alpha"]


def test_unported_options_raise():
    """The cold tier is no pipeline stage (it is the cache's own last
    stage, tests/test_torch_tiered.py), and the simulation's ablation seams
    are not ported: both are refused. The default index backend, ``auto``,
    is ported (a host index, as in repro)."""
    with pytest.raises(ValueError, match="unknown pipeline stage"):
        build_pipeline(["cold"])
    with pytest.raises(TypeError, match="evict_during_wave"):
        PlanCache(evict_during_wave=True)
    assert PlanCache().pipeline.stage("fuzzy") is None  # exact-only builds no index
    index = PlanCache(fuzzy=True).pipeline.stage("fuzzy").index
    assert index.backend == "auto" and index.device is None
