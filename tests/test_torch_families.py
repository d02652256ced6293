"""chip_smoke.py's phase-8 serving runs on the CPU: the moe, qwen3 and vlm
archs (``families``) and the FLAGSHIP deployment (kimi-k2 as the large
planner) through the port's TorchBackend on its smoke engines, against the
reference's JaxBackend on its smoke engines, on the same 8 QASPER tasks
(seed 0). Their own file, beside tests/test_torch_agent.py: the
reference's engines compile a prefill per prompt length, about 25 s a run,
and a file of its own runs on its own worker."""

import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core.agent_loop import AgentConfig as JAgentConfig  # noqa: E402
from repro.core.agent_loop import PlanActAgent as JAgent  # noqa: E402
from repro.core.cost_model import CostLedger as JLedger  # noqa: E402
from repro.envs.workloads import get_env as jget_env  # noqa: E402
from repro.serving.jax_backend import JaxBackend  # noqa: E402
from repro_torch.core.agent_loop import AgentConfig, PlanActAgent  # noqa: E402
from repro_torch.core.cost_model import CostLedger  # noqa: E402
from repro_torch.envs.workloads import get_env  # noqa: E402
from repro_torch.serving.torch_backend import TorchBackend  # noqa: E402

torch.set_num_threads(2)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

WALL_CLOCK = ("latency_s", "cache_lookup_s")  # timed with perf_counter


def _run(agent_cls, cfg_cls, ledger_cls, backend, pricing, tasks):
    ledger = ledger_cls(pricing_map=dict(pricing))
    agent = agent_cls(backend, ledger, cfg_cls(cache_capacity=100, method="apc"))
    return [agent.run_task(t) for t in tasks], ledger


def _assert_same_records(recs_t, recs_j):
    """Every RunRecord field is identical except the wall-clock lookup time
    and the latency share that includes it (as tests/test_torch_agent.py)."""
    for rj, rt in zip(recs_j, recs_t, strict=True):
        dj, dt = dataclasses.asdict(rj), dataclasses.asdict(rt)
        assert set(dj) == set(dt)
        for k in dj:
            if k not in WALL_CLOCK:
                assert dt[k] == dj[k], (rt.task_id, k)
        assert (rt.latency_s - rt.cache_lookup_s) == pytest.approx(
            rj.latency_s - rj.cache_lookup_s, rel=1e-9, abs=1e-6)


@pytest.mark.parametrize("run", ["families", "flagship"])
def test_family_deployment_run_records_match_reference(run):
    """chip_smoke.py's phase-8 runs on smoke engines, exact `apc`:
    `families` (granite-moe small planner, qwen3-4b keyword extractor,
    qwen2-vl actor, nemotron large planner) and `flagship` (the FLAGSHIP
    deployment: kimi-k2 large planner). The port's TorchBackend on its CPU
    smoke engines and the reference's JaxBackend on its smoke engines give
    equal RunRecords and ledgers, and the (hits, accuracy, cost)
    chip_smoke.py pins for the runs on the card; every new arch served
    tokens."""
    from repro.configs.apc_minion import APCDeployment as JDeployment
    from repro.configs.apc_minion import FLAGSHIP as JFLAGSHIP
    from repro.launch.serve import build_engines as jbuild_engines
    from repro_torch.configs.apc_minion import FLAGSHIP, APCDeployment
    from repro_torch.launch.serve import build_engines

    if run == "families":
        roles = chip_smoke.FAMILIES_ROLES
        assert roles == {"small_planner": "granite-moe-1b-a400m",
                         "keyword_extractor": "qwen3-4b", "actor": "qwen2-vl-7b"}
        jdep, tdep, served = JDeployment(**roles), APCDeployment(**roles), list(roles)
    else:
        jdep, tdep, served = JFLAGSHIP, FLAGSHIP, ["large_planner"]
        assert tdep.large_planner == jdep.large_planner == "kimi-k2-1t-a32b"
    assert jdep.pricing == tdep.pricing
    env, n, expect = chip_smoke.PHASE8_ENV, chip_smoke.PHASE8_TASKS, chip_smoke.PHASE8_EXPECT[run]
    jeng = jbuild_engines(jdep, full=False, max_len=192)
    teng = build_engines(tdep, full=False, max_len=192, device="cpu")
    recs_j, led_j = _run(JAgent, JAgentConfig, JLedger, JaxBackend(jeng, seed=0),
                            jdep.pricing, jget_env(env).generate(n, seed=0))
    recs_t, led_t = _run(PlanActAgent, AgentConfig, CostLedger, TorchBackend(teng, seed=0),
                            tdep.pricing, get_env(env).generate(n, seed=0))
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    got = (sum(r.hit for r in recs_t), sum(r.correct for r in recs_t) / n,
           round(led_t.total_cost(), 4))
    assert got == tuple(expect) and got[0] > 0  # a hit: the small planner served
    for role in served:
        assert teng[role].stats.decode_tokens > 0, role
