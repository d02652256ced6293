"""The port's cold tier (``repro_torch.memory.tiered`` under ``PlanCache``
and ``DistributedPlanCache``) against ``repro``'s on the same op streams:
tests/test_memory.py's cold-tier cases for every store x policy x backend
the port runs on the CPU (``device`` on ``device="cpu"``), each run's
lookups, each node's hot and cold keys and the tiered counters compared
with the reference's; the pins ``chip_smoke.py`` holds its card run to;
template round trips and compaction; the segment format each package reads
from the other; the armed crash between segment and manifest; refcount gc.
Everything is compared exactly."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core.cache import PlanCache as JPlanCache  # noqa: E402
from repro.core.distributed_cache import DistributedPlanCache as JDist  # noqa: E402
from repro.core.template import PlanStep as JStep  # noqa: E402
from repro.core.template import PlanTemplate as JTemplate  # noqa: E402
from repro.memory import tiered as jtiered  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.core.distributed_cache import DistributedPlanCache  # noqa: E402
from repro_torch.core.template import PlanStep, PlanTemplate  # noqa: E402
from repro_torch.memory import tiered  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

STORE_KINDS = ["plan", "distributed"]
POLICIES = ["lru", "lfu", "cost"]
BACKENDS = [None, "brute", "bucketed", "device"]  # None: exact-only pipeline


def _store(port: bool, kind, policy, backend, cold_dir, **extra):
    kw = dict(eviction=policy, **extra)
    if backend is not None:
        kw.update(fuzzy=True, fuzzy_threshold=0.7, index_backend=backend)
        if port and backend == "device":
            kw["device"] = "cpu"
    if kind == "plan":
        return (PlanCache if port else JPlanCache)(capacity=4, cold_dir=cold_dir, **kw)
    return (DistributedPlanCache if port else JDist)(2, replication=1, capacity_per_node=4,
                                                     cold_dir=cold_dir, **kw)


def _shards(store):
    return [store.shards[n] for n in sorted(store.shards)] if hasattr(store, "shards") \
        else [store]


def _state(store):
    return {"keys": sorted(store.keys()), "len": len(store),
            "shards": [(sorted(sh.keys()), sh.cold.keys(), sh.cold.snapshot(),
                        sh.cold.live_segments(), sh.stats.cold_snapshot(),
                        {k: v for k, v in sh.stats.snapshot().items()
                         if k != "lookup_time_s"}) for sh in _shards(store)]}


def _conformance(store):
    """test_memory.py::test_cold_tier_conformance's stream, every outcome kept."""
    keys = [f"key number {i}" for i in range(12)]
    out = []
    store.insert_batch([(k, i) for i, k in enumerate(keys)])
    out.append(_state(store))
    out.append(store.lookup_batch(keys))
    out.append(_state(store))
    out.append([store.remove(keys[0]), store.lookup(keys[0]), store.remove(keys[0])])
    out.append(_state(store))
    store.clear()
    out.append(_state(store))
    out.append(store.lookup_batch(keys))
    return out


@pytest.mark.parametrize("kind", STORE_KINDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_tier_conformance_matches_reference(kind, policy, backend, tmp_path):
    ref = _conformance(_store(False, kind, policy, backend, str(tmp_path / "j")))
    got = _conformance(_store(True, kind, policy, backend, str(tmp_path / "t")))
    assert got == ref
    # the reference test's invariants hold on the port too
    after = got[2]
    assert after["len"] <= 4 * len(after["shards"])
    assert sum(sh[4]["spills"] for sh in after["shards"]) > 0
    if backend is None:
        assert sum(sh[4]["promotes"] for sh in after["shards"]) > 0
        assert got[3][1] is None and got[6] == [None] * 12


@pytest.mark.parametrize("name", list(chip_smoke.COLD_EXPECT))
def test_chip_smoke_cold_pins_match_reference(name, tmp_path):
    """chip_smoke.py's phase 9(d) pins are the reference's outcome on the
    CPU, and the port's on its CPU ``device`` index."""
    want = chip_smoke.COLD_EXPECT[name]
    ref = chip_smoke.cold_stream(chip_smoke.make_cold_store(JPlanCache, JDist, name,
                                                            str(tmp_path / "j")))
    got = chip_smoke.cold_stream(chip_smoke.make_cold_store(PlanCache, DistributedPlanCache,
                                                            name, str(tmp_path / "t"),
                                                            device="cpu"))
    assert ref == want
    assert got == want


def _template(mod_step, mod_tpl, n_outputs=4, body="x" * 300):
    steps = [mod_step("message", f"round {i}: {body}", {"tool": "search", "arg": f"slot-{i}"})
             for i in range(2)]
    steps += [mod_step("output", f"observation {i}: {body}", None) for i in range(n_outputs)]
    steps += [mod_step("answer", f"final: {body}", None)]
    return mod_tpl("sample keyword", steps, source_task="task " + body)


def test_spill_promote_preserves_template_semantics(tmp_path):
    tpl = _template(PlanStep, PlanTemplate)
    c = PlanCache(capacity=1, cold_dir=str(tmp_path / "cold"), cold_budget_tokens=10**6)
    c.insert("tpl key", tpl, context="the source query")
    c.insert("filler key", 0)  # evicts and spills the template
    assert "tpl key" not in c and "tpl key" in c.cold
    back = c.lookup("tpl key")  # promote
    assert back is not tpl
    assert [s.to_json() for s in back.steps] == [s.to_json() for s in tpl.steps]
    assert (back.keyword, back.source_task, back.uses) == (tpl.keyword, tpl.source_task,
                                                           tpl.uses)
    assert c._store["tpl key"].context == "the source query"
    assert c.stats.cold_snapshot() == {"cold_hits": 1, "spills": 2, "promotes": 1,
                                       "compaction_saved_tokens": 0, "stale_insert_skips": 0}


def test_plan_step_json_roundtrip():
    s = PlanStep("message", "fetch {company}", {"retrieve": ["revenue"]})
    assert PlanStep.from_json(s.to_json()) == s
    assert s.to_json() == JStep(s.kind, s.content, s.op).to_json()


@pytest.mark.parametrize("budget", [10**6, 160, 60, 1])
@pytest.mark.parametrize("n_outputs", [0, 1, 4])
def test_compaction_matches_reference(budget, n_outputs):
    tpl = _template(PlanStep, PlanTemplate, n_outputs)
    jtpl = _template(JStep, JTemplate, n_outputs)
    once, saved = tiered.compact_template(tpl, budget_tokens=budget)
    jonce, jsaved = jtiered.compact_template(jtpl, budget_tokens=budget)
    assert saved == jsaved
    assert [s.to_json() for s in once.steps] == [s.to_json() for s in jonce.steps]
    assert (once.source_task, once.size_tokens()) == (jonce.source_task, jonce.size_tokens())
    twice, saved2 = tiered.compact_template(once, budget_tokens=budget)
    assert saved2 == 0 and [s.to_json() for s in twice.steps] == [s.to_json() for s in once.steps]
    assert tiered.compact_template({"k": 1}, budget_tokens=1) == ({"k": 1}, 0)


def _entries(mod_step, mod_tpl):
    return [("tpl", _template(mod_step, mod_tpl), "ctx", [0.5, -0.25, 1.0], 3.0),
            ("plain", {"v": [1, 2]}, None, None, 0.0)]


def test_segments_read_across_packages(tmp_path):
    """A segment either package spills is read by the other (the same
    payload through the same checkpoint format)."""
    j = jtiered.ColdTier(str(tmp_path / "a"), budget_tokens=60)
    j.spill(_entries(JStep, JTemplate))
    t = tiered.ColdTier(str(tmp_path / "a"), budget_tokens=60)
    assert t._next_segment == 1  # adopts the committed segment's id
    t.manifest, t._seg_refs = dict(j.manifest), dict(j._seg_refs)
    got = t.fetch(["tpl", "plain", "absent"])
    want = j.fetch(["tpl", "plain", "absent"])
    for g, w in zip(got[:2], want[:2]):
        assert g.context == w.context
        assert (g.vector is None) == (w.vector is None)
        if g.vector is not None:
            assert g.vector.tolist() == w.vector.tolist()
    assert [s.to_json() for s in got[0].value.steps] == [s.to_json() for s in want[0].value.steps]
    assert got[1].value == want[1].value and got[2] is None and want[2] is None

    t2 = tiered.ColdTier(str(tmp_path / "b"), budget_tokens=60)
    t2.spill(_entries(PlanStep, PlanTemplate))
    j2 = jtiered.ColdTier(str(tmp_path / "b"), budget_tokens=60)
    j2.manifest, j2._seg_refs = dict(t2.manifest), dict(t2._seg_refs)
    assert j2._read_segment(0) == t2._read_segment(0)
    assert t2.manifest == j.manifest


def test_armed_crash_loses_the_wave_like_the_reference(tmp_path):
    out = []
    for mod, step, tpl, d in ((jtiered, JStep, JTemplate, "j"), (tiered, PlanStep, PlanTemplate,
                                                                "t")):
        tier = mod.ColdTier(str(tmp_path / d), keep_last=0)
        tier.arm_crash_after_segment(1)
        saved = tier.spill(_entries(step, tpl))
        crashed = (len(tier), tier.store.committed_steps(), saved)
        tier.spill(_entries(step, tpl))
        out.append((crashed, tier.keys(), tier.live_segments(), tier.store.committed_steps()))
    assert out[1] == out[0]
    assert out[0][0][0] == 0 and out[0][2] == [1]


def test_distributed_arm_cold_crash_matches_reference(tmp_path):
    runs = []
    for port in (False, True):
        s = _store(port, "distributed", "lru", None, str(tmp_path / ("t" if port else "j")))
        s.arm_cold_crash(1)
        keys = [f"key number {i}" for i in range(12)]
        s.insert_batch([(k, i) for i, k in enumerate(keys)])
        runs.append((_state(s), s.lookup_batch(keys), _state(s)))
    assert runs[1] == runs[0]


@pytest.mark.parametrize("refcount_gc", [True, False])
def test_refcount_gc_matches_reference(refcount_gc, tmp_path):
    """Live segments survive keep_last rotation only with refcount gc (the
    reference's ablation drops the pin and loses the old wave)."""
    out = []
    for mod, d in ((jtiered, "j"), (tiered, "t")):
        tier = mod.ColdTier(str(tmp_path / d), keep_last=1, refcount_gc=refcount_gc)
        for w in range(4):
            tier.spill([(f"k{w}", w, None, None, 0.0)])
        got = tier.fetch([f"k{w}" for w in range(4)])
        out.append(([None if e is None else e.value for e in got], tier.keys(),
                    tier.store.committed_steps(), tier.snapshot()))
    assert out[1] == out[0]
    assert (out[0][0][0] is not None) == refcount_gc


def test_restart_node_drops_the_cold_manifest_like_the_reference(tmp_path):
    runs = []
    for port in (False, True):
        s = _store(port, "distributed", "lru", None, str(tmp_path / ("t" if port else "j")))
        keys = [f"key number {i}" for i in range(12)]
        s.insert_batch([(k, i) for i, k in enumerate(keys)])
        s.restart_node("cache-0", recover=True)
        runs.append((_state(s), s.lookup_batch(keys)))
    assert runs[1] == runs[0]
