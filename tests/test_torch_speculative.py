"""The port's speculative plan execution against ``repro``'s: the step
journal's op streams (``on_commit``, ``commit(upto)``, ``rollback``,
``patch``), ``PlanSpeculator``, ``KeywordPredictor`` and
``SpeculativePrefetcher``, and the ``speculative`` method through
``harness.run_workload`` on the two streams ``chip_smoke.py`` serves on the
card and on one that patches, and on smoke engines against ``JaxBackend``."""

import collections
import dataclasses
import os
import random
import sys

import pytest

pytest.importorskip("torch")

from repro.core import journal as jjournal  # noqa: E402
from repro.core import speculative as jspec  # noqa: E402
from repro.envs.base import Workspace as JWorkspace  # noqa: E402
from repro_torch.core import journal as tjournal  # noqa: E402
from repro_torch.core import speculative as tspec  # noqa: E402
from repro_torch.envs.base import Workspace  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

WALL_CLOCK = ("latency_s", "cache_lookup_s")  # timed with perf_counter


def _contents(ws):
    return {k: ws.read(k) for k in ws.keys()}


def _journal_ops(jmod, ws_cls, seed):
    """A seeded stream of journal ops over one workspace; every return value,
    the workspace after each op and the commit log are recorded."""
    rng = random.Random(seed)
    journal, ws, log, seen = jmod.StepJournal(), ws_cls(), [], []
    for n in range(200):
        op = rng.random()
        try:
            if op < 0.45:
                step = journal.begin_step(f"s{n}")
                for _ in range(rng.randrange(3)):
                    step.applied(ws.write(rng.choice("abcde"), n))
                if rng.random() < 0.6:
                    step.on_commit(lambda n=n: log.append(n))
                got = (step.index, step.label)
            elif op < 0.6:
                got = journal.commit(upto=rng.choice([None, 0, 1, 2, 5]))
            elif op < 0.75:
                got = journal.rollback(from_step=rng.randrange(-1, journal.open_steps() + 2))
            elif op < 0.9:
                got = journal.patch(keep=rng.randrange(0, journal.open_steps() + 2))
            else:
                got = journal.commit(upto=-1)
        except ValueError as e:
            got = ("ValueError", str(e))
        seen.append((got, journal.open_steps(), _contents(ws), list(log)))
    counters = (journal.steps_recorded, journal.steps_committed, journal.steps_rolled_back)
    return seen, counters


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_journal_op_streams_match_reference(seed):
    got = _journal_ops(tjournal, Workspace, seed)
    assert got == _journal_ops(jjournal, JWorkspace, seed)
    assert got[1][1] > 0 and got[1][2] > 0  # both commits and rollbacks ran


def _speculator_ops(mod, ws_cls, seed, rollback_enabled):
    rng = random.Random(seed)
    spec = mod.PlanSpeculator(rollback_enabled=rollback_enabled)
    ws, admitted, seen = ws_cls(), [], []
    open_ids = []
    for n in range(120):
        if not open_ids or rng.random() < 0.55:
            kw = f"kw{rng.randrange(6)}"
            effect = (lambda n=n, kw=kw: ws.write(kw, n)) if rng.random() < 0.7 else None
            sid = spec.begin(kw, effect=effect,
                             on_commit=(lambda kw=kw, n=n: admitted.append((kw, n)),))
            open_ids.append(sid)
            seen.append(("begin", sid, spec.pending_keys()))
        else:
            sid = open_ids.pop(rng.randrange(len(open_ids)))  # out of order
            seen.append(("resolve", sid, spec.resolve(sid, rng.random() < 0.5)))
        seen.append((_contents(ws), list(admitted), spec.stats()))
    return seen


@pytest.mark.parametrize("rollback_enabled", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_speculator_matches_reference(seed, rollback_enabled):
    got = _speculator_ops(tspec, Workspace, seed, rollback_enabled)
    assert got == _speculator_ops(jspec, JWorkspace, seed, rollback_enabled)
    stats = got[-1][-1]
    assert stats["commits"] > 0
    assert (stats["rollbacks"] > 0) == rollback_enabled
    assert (stats["forced_commits"] > 0) == (not rollback_enabled)


@pytest.mark.parametrize("generate", [False, True])
def test_keyword_predictor_and_prefetcher_match_reference(generate):
    """A Zipf keyword stream through predictor + prefetcher over an LRU
    cache in each package: equal predictions, counters and cache contents."""
    import numpy as np

    from repro.core.cache import PlanCache as JPlanCache
    from repro_torch.core.cache import PlanCache

    rs = np.random.RandomState(0)
    names = [f"intent {i}" for i in range(12)]
    p = 1.0 / np.arange(1, 13)
    stream = list(rs.choice(names, size=300, p=p / p.sum()))
    out = []
    for mod, cache_cls in ((jspec, JPlanCache), (tspec, PlanCache)):
        cache = cache_cls(capacity=5)
        pred = mod.KeywordPredictor()
        pf = mod.SpeculativePrefetcher(
            cache, pred, generate_fn=(lambda kw: f"tpl:{kw}") if generate else None)
        trace = []
        for kw in stream:
            if cache.lookup(kw) is None:
                cache.insert(kw, kw.upper())
            pf.on_request(kw)
            trace.append(pred.predict(2))
        out.append((trace, pf.prefetches, pf.generated, cache.keys(),
                    cache.stats.hits, cache.stats.misses))
    assert out[0] == out[1]
    assert out[1][1] > 0 and (out[1][2] > 0) == generate


def _assert_same_records(recs_t, recs_j):
    for rj, rt in zip(recs_j, recs_t, strict=True):
        dj, dt = dataclasses.asdict(rj), dataclasses.asdict(rt)
        assert set(dj) == set(dt)
        for k in dj:
            if k not in WALL_CLOCK:
                assert dt[k] == dj[k], (rt.task_id, k)
        assert (rt.latency_s - rt.cache_lookup_s) == pytest.approx(
            rj.latency_s - rj.cache_lookup_s, rel=1e-9, abs=1e-6)


def _census(records):
    c = collections.Counter(r.spec_outcome for r in records if r.speculated)
    return {k: c[k] for k in ("commit", "patch", "rollback")}


# (env, tasks, seed) -> the census; the first two are chip_smoke.py's
# phase-7 runs (their pins checked below), the third reaches a patch
SPEC_STREAMS = {
    "aime-8": ("aime", 8, 0, {"commit": 1, "patch": 0, "rollback": 0}),
    "financebench-16": ("financebench", 16, 0, {"commit": 0, "patch": 0, "rollback": 1}),
    "financebench-80-seed3": ("financebench", 80, 3, {"commit": 3, "patch": 1, "rollback": 17}),
}


@pytest.mark.parametrize("stream", list(SPEC_STREAMS))
def test_speculative_method_matches_reference(stream):
    """``speculative`` at fuzzy 0.6 through ``harness.run_workload``: the
    port's ``device`` index on the CPU against the reference's ``device``
    index, equal RunRecords, ledgers, rows and outcome census."""
    from repro.core.agent_loop import AgentConfig as JAgentConfig
    from repro.core.harness import run_workload as jrun_workload
    from repro_torch.core.agent_loop import AgentConfig
    from repro_torch.core.harness import run_workload

    env, n, seed, census = SPEC_STREAMS[stream]
    got = run_workload(env, "speculative", n, seed=seed, keep_records=True,
                       agent_cfg=AgentConfig(fuzzy_threshold=0.6, index_backend="device",
                                             index_device="cpu"))
    want = jrun_workload(env, "speculative", n, seed=seed, keep_records=True,
                         agent_cfg=JAgentConfig(fuzzy_threshold=0.6, index_backend="device"))
    _assert_same_records(got.records, want.records)
    assert got.breakdown == want.breakdown
    row, jrow = got.row(), want.row()
    row.pop("latency_s"), jrow.pop("latency_s")  # wall-clock lookups: the records hold the rest
    assert row == jrow
    assert _census(got.records) == _census(want.records) == census


@pytest.mark.parametrize("run", [r[0] for r in chip_smoke.SPEC_RUNS])
def test_chip_smoke_speculative_pins_match_reference(run):
    """chip_smoke.py pins each phase-7 speculative run's (hits, accuracy,
    cost) and outcome census on the card: the reference gives those on the
    same tasks, and so does the port on the CPU."""
    from repro.configs.apc_minion import DEFAULT as JDEFAULT
    from repro.core.agent_loop import AgentConfig as JAgentConfig
    from repro.core.agent_loop import PlanActAgent as JAgent
    from repro.core.backends import SimulatedBackend as JSim
    from repro.core.cost_model import CostLedger as JLedger
    from repro.envs.workloads import get_env as jget_env
    from repro_torch.configs.apc_minion import DEFAULT
    from repro_torch.core.agent_loop import AgentConfig, PlanActAgent
    from repro_torch.core.backends import SimulatedBackend
    from repro_torch.core.cost_model import CostLedger
    from repro_torch.envs.workloads import get_env

    _, env, n, make, expect, path, census = next(r for r in chip_smoke.SPEC_RUNS if r[0] == run)
    assert make.cfg["method"] == "speculative" and make.cfg["index_backend"] == "device"
    assert set(path) == {"flash_attention", "decode_attention", "topk_cosine"}
    got = []
    for agent_cls, cfg_cls, led_cls, sim, pricing, envs, extra in (
            (JAgent, JAgentConfig, JLedger, JSim, JDEFAULT.pricing, jget_env, {}),
            (PlanActAgent, AgentConfig, CostLedger, SimulatedBackend, DEFAULT.pricing, get_env,
             {"index_device": "cpu"})):
        ledger = led_cls(pricing_map=dict(pricing))
        agent = agent_cls(sim(seed=0), ledger, cfg_cls(cache_capacity=100, **make.cfg, **extra))
        recs = [agent.run_task(t) for t in envs(env).generate(n, seed=0)]
        got.append((sum(r.hit for r in recs), sum(r.correct for r in recs) / n,
                    round(ledger.total_cost(), 4), _census(recs)))
    assert got[0] == got[1] == (*expect, census)


def test_speculative_on_smoke_engines_matches_reference():
    """The AIME stream's speculative run (its commit is the eighth task) with
    TorchBackend on the port's smoke engines against JaxBackend on the
    reference's: equal RunRecords and ledgers, and the port's engines
    served tokens."""
    from repro.configs.apc_minion import DEFAULT as JDEFAULT
    from repro.core.agent_loop import AgentConfig as JAgentConfig
    from repro.core.agent_loop import PlanActAgent as JAgent
    from repro.core.cost_model import CostLedger as JLedger
    from repro.envs.workloads import get_env as jget_env
    from repro.launch.serve import build_engines as jbuild_engines
    from repro.serving.jax_backend import JaxBackend
    from repro_torch.configs.apc_minion import DEFAULT
    from repro_torch.core.agent_loop import AgentConfig, PlanActAgent
    from repro_torch.core.cost_model import CostLedger
    from repro_torch.envs.workloads import get_env
    from repro_torch.launch.serve import build_engines
    from repro_torch.serving.torch_backend import TorchBackend

    cfg = {"method": "speculative", "fuzzy_threshold": 0.6}
    teng = build_engines(DEFAULT, full=False, max_len=192, device="cpu")
    jeng = jbuild_engines(JDEFAULT, full=False, max_len=192)
    out = []
    for agent_cls, cfg_cls, led_cls, backend, pricing, envs, extra in (
            (JAgent, JAgentConfig, JLedger, JaxBackend(jeng, seed=0), JDEFAULT.pricing,
             jget_env, {"index_backend": "device"}),
            (PlanActAgent, AgentConfig, CostLedger, TorchBackend(teng, seed=0), DEFAULT.pricing,
             get_env, {"index_backend": "device", "index_device": "cpu"})):
        ledger = led_cls(pricing_map=dict(pricing))
        agent = agent_cls(backend, ledger, cfg_cls(cache_capacity=100, **cfg, **extra))
        out.append(([agent.run_task(t) for t in envs("aime").generate(8, seed=0)], ledger))
    (recs_j, led_j), (recs_t, led_t) = out
    _assert_same_records(recs_t, recs_j)
    assert led_t.breakdown() == led_j.breakdown()
    assert _census(recs_t) == {"commit": 1, "patch": 0, "rollback": 0}
    assert all(e.stats.decode_tokens > 0 for e in teng.values())
