"""The slice as a whole: the port's APC control plane and torch backend
against ``repro``'s, on 16 FinanceBench tasks (seed 0)."""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.apc_minion import DEFAULT as JDEFAULT  # noqa: E402
from repro.core.agent_loop import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent_loop import PlanActAgent as JAgent  # noqa: E402
from repro.core.backends import SimulatedBackend as JSim  # noqa: E402
from repro.core.cache import PlanCache as JPlanCache  # noqa: E402
from repro.core.cost_model import CostLedger as JLedger  # noqa: E402
from repro.envs.workloads import get_env as jget_env  # noqa: E402
from repro.serving.jax_backend import JaxBackend  # noqa: E402
from repro_torch.configs.apc_minion import DEFAULT  # noqa: E402
from repro_torch.core.agent_loop import AgentConfig, PlanActAgent  # noqa: E402
from repro_torch.core.backends import SimulatedBackend  # noqa: E402
from repro_torch.core.cache import PlanCache  # noqa: E402
from repro_torch.core.cost_model import CostLedger  # noqa: E402
from repro_torch.envs.workloads import get_env  # noqa: E402
from repro_torch.serving.torch_backend import TorchBackend  # noqa: E402

N_TASKS = 16
WALL_CLOCK = ("latency_s", "cache_lookup_s")  # timed with perf_counter


def _run(agent_cls, cfg_cls, ledger_cls, backend, pricing, tasks, **cfg):
    ledger = ledger_cls(pricing_map=dict(pricing))
    agent = agent_cls(backend, ledger, cfg_cls(cache_capacity=100, **{"method": "apc", **cfg}))
    return [agent.run_task(t) for t in tasks], ledger, agent


def _assert_same_records(recs_t, recs_j):
    """Every RunRecord field is identical except the wall-clock lookup time
    and the latency share that includes it."""
    for rj, rt in zip(recs_j, recs_t, strict=True):
        dj, dt = dataclasses.asdict(rj), dataclasses.asdict(rt)
        assert set(dj) == set(dt)
        for k in dj:
            if k not in WALL_CLOCK:
                assert dt[k] == dj[k], (rt.task_id, k)
        assert (rt.latency_s - rt.cache_lookup_s) == pytest.approx(
            rj.latency_s - rj.cache_lookup_s, rel=1e-9, abs=1e-6)


# (tasks, the method's config, the reference's index backend, its hits,
# accuracy and cost on FinanceBench seed 0); the port's index is always
# `device` on the CPU
AGENT_CASES = {
    "exact": (16, {}, None, 2, 0.875, 0.2987),
    "fuzzy-0.6": (16, {"fuzzy": True, "fuzzy_threshold": 0.6}, "pallas", 3, 0.8125, 0.2804),
    "fuzzy-0.8": (64, {"fuzzy": True, "fuzzy_threshold": 0.8}, "device", 16, 0.859375, 1.0001),
    "semantic": (16, {"method": "semantic"}, "device", 2, 0.8125, 0.2953),
}


@pytest.mark.parametrize("case", list(AGENT_CASES))
def test_agent_run_records_match_reference(case):
    """The port's agent against repro's on the same tasks: identical
    RunRecords and ledgers, and the reference's hits, accuracy and cost.
    The reference's fuzzy/semantic index runs its Pallas kernel in
    interpret mode (`pallas`) or its dense device path (`device`)."""
    n, cfg, jbackend, n_hits, acc, cost = AGENT_CASES[case]
    jcfg, tcfg = dict(cfg), dict(cfg)
    if jbackend is not None:
        jcfg["index_backend"] = jbackend
        tcfg.update(index_backend="device", index_device="cpu")
    recs_j, led_j, ag_j = _run(JAgent, JAgentConfig, JLedger, JSim(seed=0), JDEFAULT.pricing,
                               jget_env("financebench").generate(n, seed=0), **jcfg)
    recs_t, led_t, ag_t = _run(PlanActAgent, AgentConfig, CostLedger, SimulatedBackend(seed=0),
                               DEFAULT.pricing, get_env("financebench").generate(n, seed=0),
                               **tcfg)
    assert len(recs_t) == n
    hits = [i for i, r in enumerate(recs_t) if r.hit]
    assert len(hits) == n_hits and n_hits < n  # both the hit and the miss path ran
    assert sum(r.correct for r in recs_t) / n == acc
    assert round(led_t.total_cost(), 4) == cost
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    assert len(ag_t.cache) == len(ag_j.cache)
    assert (ag_t.cache.stats.hits, ag_t.cache.stats.misses) == (
        ag_j.cache.stats.hits, ag_j.cache.stats.misses)


def test_plan_cache_matches_reference_lru():
    """The trimmed exact/LRU PlanCache answers a random lookup/insert
    stream exactly as the reference store does."""
    rng = random.Random(0)
    j, t = JPlanCache(capacity=5), PlanCache(capacity=5)
    keys = [f"k{i}" for i in range(12)]
    for step in range(600):
        k = rng.choice(keys)
        if rng.random() < 0.5:
            assert t.lookup(k) == j.lookup(k), step
        else:
            j.insert(k, step)
            t.insert(k, step)
        assert len(t) == len(j) and all((x in t) == (x in j) for x in keys)
    assert (t.stats.hits, t.stats.misses, t.stats.evictions) == (
        j.stats.hits, j.stats.misses, j.stats.evictions)


class _Recorder:
    """An engine stand-in: records every generate call the backend makes."""

    max_len = 192

    def __init__(self, role, calls):
        self.role, self.calls = role, calls

    def generate(self, ids, max_new):
        self.calls.append((self.role, np.asarray(ids).tolist(), max_new))
        return np.zeros((ids.shape[0], max_new), np.int32)

    def measured_rates(self):
        return {"prefill": 1.0, "decode": 1.0, "rtt": 0.0}


def test_torch_backend_issues_the_reference_calls():
    """TorchBackend and JaxBackend, driving recording engines through the
    same agent run, issue the same (role, prompt ids, max_new) sequence."""
    roles = ("large_planner", "small_planner", "actor", "keyword_extractor")
    calls_j, calls_t = [], []
    be_j = JaxBackend({r: _Recorder(r, calls_j) for r in roles}, seed=0)
    be_t = TorchBackend({r: _Recorder(r, calls_t) for r in roles}, seed=0)
    recs_j, _, _ = _run(JAgent, JAgentConfig, JLedger, be_j, JDEFAULT.pricing,
                        jget_env("financebench").generate(N_TASKS, seed=0))
    recs_t, _, _ = _run(PlanActAgent, AgentConfig, CostLedger, be_t, DEFAULT.pricing,
                        get_env("financebench").generate(N_TASKS, seed=0))
    assert [r.hit for r in recs_t] == [r.hit for r in recs_j]
    assert len(calls_t) == 72  # 16 keyword + 31 large + 5 adapt + 20 actor
    assert calls_t == calls_j
    assert max(len(ids[0]) for _, ids, _ in calls_t) <= 192 - 32 - 8
    assert be_t.measured_rates() == be_j.measured_rates()


def test_torch_backend_fuzzy_run_on_smoke_engines():
    """The fuzzy path end to end on the CPU: TorchBackend driving the three
    DEFAULT archs' smoke engines, `apc` with fuzzy matching at 0.6 on the
    `device` index (on the CPU), gives the reference's records."""
    from repro_torch.launch.serve import build_engines

    engines = build_engines(DEFAULT, full=False, max_len=192, device="cpu")
    cfg = {"fuzzy": True, "fuzzy_threshold": 0.6}
    recs_j, led_j, _ = _run(JAgent, JAgentConfig, JLedger, JSim(seed=0), JDEFAULT.pricing,
                            jget_env("financebench").generate(N_TASKS, seed=0),
                            index_backend="pallas", **cfg)
    recs_t, led_t, ag_t = _run(PlanActAgent, AgentConfig, CostLedger,
                               TorchBackend(engines, seed=0), DEFAULT.pricing,
                               get_env("financebench").generate(N_TASKS, seed=0),
                               index_backend="device", index_device="cpu", **cfg)
    assert sum(r.hit for r in recs_t) == 3
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    assert ag_t.cache.pipeline.stage("fuzzy").index.device.type == "cpu"
    assert sum(e.stats.decode_tokens for e in {id(e): e for e in engines.values()}.values()) > 0


def test_recurrent_deployment_run_records_match_reference():
    """chip_smoke.py's `recurrent` run on smoke engines: exact `apc` on a
    deployment whose small planner and keyword extractor are rwkv6-3b and
    whose actor is zamba2-2.7b. The port's TorchBackend on its CPU smoke
    engines and the reference's JaxBackend on its smoke engines give equal
    RunRecords and ledgers, and the (hits, accuracy, cost) chip_smoke.py
    pins for the run on the card (RECURRENT_EXPECT)."""
    import os
    import sys

    from repro.configs.apc_minion import APCDeployment as JDeployment
    from repro.launch.serve import build_engines as jbuild_engines
    from repro_torch.configs.apc_minion import APCDeployment
    from repro_torch.launch.serve import build_engines

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    roles = chip_smoke.RECURRENT_ROLES
    assert roles == {"small_planner": "rwkv6-3b", "keyword_extractor": "rwkv6-3b",
                     "actor": "zamba2-2.7b"}
    jdep, tdep = JDeployment(**roles), APCDeployment(**roles)
    assert jdep.pricing == tdep.pricing
    jeng = jbuild_engines(jdep, full=False, max_len=192)
    teng = build_engines(tdep, full=False, max_len=192, device="cpu")
    assert {r: e.cfg.family for r, e in teng.items()} == {
        r: e.cfg.family for r, e in jeng.items()}
    recs_j, led_j, _ = _run(JAgent, JAgentConfig, JLedger, JaxBackend(jeng, seed=0),
                            jdep.pricing, jget_env("financebench").generate(N_TASKS, seed=0))
    recs_t, led_t, _ = _run(PlanActAgent, AgentConfig, CostLedger, TorchBackend(teng, seed=0),
                            tdep.pricing, get_env("financebench").generate(N_TASKS, seed=0))
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    got = (sum(r.hit for r in recs_t), sum(r.correct for r in recs_t) / N_TASKS,
           round(led_t.total_cost(), 4))
    assert got == chip_smoke.RECURRENT_EXPECT == (2, 0.875, 0.2987)
    for role in ("small_planner", "actor"):  # the recurrent engines served real tokens
        assert teng[role].stats.decode_tokens > 0


# -- the paper's baselines, its five workloads and its second agent ----------

ENVS = ["financebench", "tabmwp", "qasper", "aime", "gaia"]
MATRIX_METHODS = ["apc", "accuracy_optimal", "cost_optimal", "semantic", "full_history",
                  "cascade", "speculative"]
MATRIX_TASKS = 24


@pytest.mark.parametrize("method", MATRIX_METHODS)
@pytest.mark.parametrize("env", ENVS)
def test_workload_matrix_matches_reference(env, method):
    """``harness.run_workload`` of every (env x method) at default
    AgentConfig (so the ``auto`` index backend, on the host): the port's
    RunRecords, ledger breakdown and ``row()`` equal the reference's, the
    row's wall-clock latency aside (checked through the records)."""
    from repro.core.harness import run_workload as jrun_workload
    from repro_torch.core.harness import run_workload

    got = run_workload(env, method, MATRIX_TASKS, keep_records=True)
    want = jrun_workload(env, method, MATRIX_TASKS, keep_records=True)
    _assert_same_records(got.records, want.records)
    row, jrow = got.row(), want.row()
    assert row.pop("latency_s") == pytest.approx(jrow.pop("latency_s"), abs=0.11)
    assert row == jrow
    assert got.breakdown == want.breakdown
    if method in ("accuracy_optimal", "cost_optimal"):
        assert row["hit_rate"] == 0 and row["cache_entries"] == 0
    elif env in ("qasper", "aime") and method in ("semantic", "cascade"):
        assert row["hit_rate"] > 0  # the semantic stage served hits


def test_harness_methods_match_reference():
    from repro.core import harness as jharness
    from repro_torch.core import harness

    assert harness.METHODS == jharness.METHODS
    assert set(MATRIX_METHODS) == set(harness.METHODS)


@pytest.mark.parametrize("use_apc", [True, False])
@pytest.mark.parametrize("env", ["gaia", "financebench"])
def test_deep_research_matches_reference(env, use_apc):
    """``run_deep_research`` with and without APC (the no-cache arm is a
    capacity-0 PlanCache), and the agent's RunRecords on the same tasks."""
    from repro.core.deep_research import DeepResearchAgent as JDeep
    from repro.core.deep_research import DeepResearchConfig as JDeepCfg
    from repro.core.deep_research import run_deep_research as jrun
    from repro_torch.core.deep_research import (
        DeepResearchAgent,
        DeepResearchConfig,
        run_deep_research,
    )

    got, want = run_deep_research(env, 16, use_apc=use_apc), jrun(env, 16, use_apc=use_apc)
    assert got.pop("latency_s") == pytest.approx(want.pop("latency_s"), abs=1e-2)
    assert got == want
    assert (got["hit_rate"] > 0) == use_apc
    recs = []
    for agent_cls, cfg_cls, sim, ledger_cls, cache_cls, pricing, envs in (
            (DeepResearchAgent, DeepResearchConfig, SimulatedBackend, CostLedger, PlanCache,
             DEFAULT.pricing, get_env),
            (JDeep, JDeepCfg, JSim, JLedger, JPlanCache, JDEFAULT.pricing, jget_env)):
        agent = agent_cls(sim(seed=0), ledger_cls(pricing_map=dict(pricing)), cfg_cls(),
                          cache_cls(100 if use_apc else 0))
        recs.append([agent.run_task(t) for t in envs(env).generate(16, seed=0)])
    _assert_same_records(*recs)


def test_prewarm_matches_reference():
    """``prewarm`` on offline samples (another seed) fills the same
    templates at the same offline cost, and the warmed agent then serves
    the reference's records."""
    offline_t = get_env("aime").generate(12, seed=3)
    offline_j = jget_env("aime").generate(12, seed=3)
    led_t, led_j = CostLedger(pricing_map=dict(DEFAULT.pricing)), JLedger(
        pricing_map=dict(JDEFAULT.pricing))
    ag_t = PlanActAgent(SimulatedBackend(seed=0), led_t, AgentConfig())
    ag_j = JAgent(JSim(seed=0), led_j, JAgentConfig())
    n = ag_t.prewarm(offline_t)
    assert n == ag_j.prewarm(offline_j) and 0 < n < 12  # repeated intents are skipped
    assert sorted(ag_t.cache.keys()) == sorted(ag_j.cache.keys())
    assert led_t.breakdown() == led_j.breakdown()
    recs_t = [ag_t.run_task(t) for t in get_env("aime").generate(8, seed=0)]
    recs_j = [ag_j.run_task(t) for t in jget_env("aime").generate(8, seed=0)]
    _assert_same_records(recs_t, recs_j)
    assert sum(r.hit for r in recs_t) > 1  # the warmed cache served hits


SMOKE_BASELINES = {  # method -> (env, tasks); the third AIME task hits
    "accuracy_optimal": ("financebench", 3),
    "full_history": ("aime", 3),
    "cascade": ("aime", 3),
}


@pytest.fixture(scope="module")
def smoke_engines():
    """The DEFAULT deployment's smoke engines in both packages (CPU)."""
    from repro.launch.serve import build_engines as jbuild_engines
    from repro_torch.launch.serve import build_engines

    return (build_engines(DEFAULT, full=False, max_len=192, device="cpu"),
            jbuild_engines(JDEFAULT, full=False, max_len=192))


@pytest.mark.parametrize("method", list(SMOKE_BASELINES))
def test_baselines_on_smoke_engines_match_reference(method, smoke_engines):
    """TorchBackend on the port's smoke engines against JaxBackend on the
    reference's, for the baselines and cascade: equal RunRecords and
    ledgers, and the port's engines served tokens."""
    env, n = SMOKE_BASELINES[method]
    teng, jeng = smoke_engines
    recs_j, led_j, _ = _run(JAgent, JAgentConfig, JLedger, JaxBackend(jeng, seed=0),
                            JDEFAULT.pricing, jget_env(env).generate(n, seed=0), method=method)
    before = {id(e): e.stats.decode_tokens for e in teng.values()}
    recs_t, led_t, _ = _run(PlanActAgent, AgentConfig, CostLedger, TorchBackend(teng, seed=0),
                            DEFAULT.pricing, get_env(env).generate(n, seed=0), method=method)
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    assert any(e.stats.decode_tokens > before[id(e)] for e in teng.values())
    assert [r.hit for r in recs_t] == [False, False, method != "accuracy_optimal"]


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize(
    "run", [r[0] for r in _chip_smoke().SERVE_RUNS + _chip_smoke().BASELINE_RUNS])
def test_chip_smoke_baseline_pins_match_reference(run):
    """chip_smoke.py pins each serving run's (hits, accuracy, cost) on the
    card: the reference gives those on the same tasks (its SimulatedBackend;
    the deep-research run is run_deep_research's APC arm), and so does the
    port on the CPU."""
    from repro.core.deep_research import run_deep_research as jrun
    from repro_torch.core.deep_research import run_deep_research

    chip_smoke = _chip_smoke()
    _, env, n, make, expect, path = next(
        r for r in chip_smoke.SERVE_RUNS + chip_smoke.BASELINE_RUNS if r[0] == run)
    assert {"flash_attention", "decode_attention"} <= set(path)
    if make is chip_smoke.deep_research:
        got = []
        for fn in (jrun, run_deep_research):
            r = fn(env, n)
            got.append((round(r["hit_rate"] * n), r["accuracy"], round(r["cost"], 4)))
    else:
        cfg = make.cfg
        tcfg = dict(cfg)
        if cfg.get("index_backend") == "device":
            tcfg["index_device"] = "cpu"
            assert "topk_cosine" in path
        got = []
        for args in ((JAgent, JAgentConfig, JLedger, JSim(seed=0), JDEFAULT.pricing,
                      jget_env(env).generate(n, seed=0), cfg),
                     (PlanActAgent, AgentConfig, CostLedger, SimulatedBackend(seed=0),
                      DEFAULT.pricing, get_env(env).generate(n, seed=0), tcfg)):
            recs, led, _ = _run(*args[:6], **args[6])
            got.append((sum(r.hit for r in recs), sum(r.correct for r in recs) / n,
                        round(led.total_cost(), 4)))
    assert got[0] == got[1] == tuple(expect)
