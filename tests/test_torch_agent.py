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
from repro_torch.envs.finance import get_env  # noqa: E402
from repro_torch.serving.torch_backend import TorchBackend  # noqa: E402

N_TASKS = 16
WALL_CLOCK = ("latency_s", "cache_lookup_s")  # timed with perf_counter


def _run(agent_cls, cfg_cls, ledger_cls, backend, pricing, tasks):
    ledger = ledger_cls(pricing_map=dict(pricing))
    agent = agent_cls(backend, ledger, cfg_cls(method="apc", cache_capacity=100))
    return [agent.run_task(t) for t in tasks], ledger, agent


def test_agent_run_records_match_reference():
    """Every RunRecord field is identical except the wall-clock lookup time
    and the latency share that includes it; the ledgers agree exactly."""
    recs_j, led_j, ag_j = _run(JAgent, JAgentConfig, JLedger, JSim(seed=0),
                               JDEFAULT.pricing, jget_env("financebench").generate(N_TASKS, seed=0))
    recs_t, led_t, ag_t = _run(PlanActAgent, AgentConfig, CostLedger, SimulatedBackend(seed=0),
                               DEFAULT.pricing, get_env("financebench").generate(N_TASKS, seed=0))
    assert len(recs_t) == N_TASKS
    hits = [i for i, r in enumerate(recs_t) if r.hit]
    assert hits and len(hits) < N_TASKS  # both the hit and the miss path ran
    for rj, rt in zip(recs_j, recs_t):
        dj, dt = dataclasses.asdict(rj), dataclasses.asdict(rt)
        assert set(dj) == set(dt)
        for k in dj:
            if k not in WALL_CLOCK:
                assert dt[k] == dj[k], (rt.task_id, k)
        assert (rt.latency_s - rt.cache_lookup_s) == pytest.approx(
            rj.latency_s - rj.cache_lookup_s, rel=1e-9, abs=1e-6)
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
