"""Open-Deep-Research-style agent (the paper's SECOND architecture, §4.2;
the twin of ``repro.core.deep_research``).

Unlike the Minion loop (planner <-> actor), a deep-research agent runs a
multi-step research trajectory: an initial plan decomposes the task into
search/extract steps, each step may trigger RE-PLANNING, and APC caches the
*re-planning* structures — the paper's GAIA finding: initial plans rarely
recur (heterogeneous tasks) but re-planning skeletons do, so APC still cuts
cost 76% there.

Implementation: the research trajectory for intent I is [survey ->
retrieve(fields) -> verify -> synthesize]; the re-plan template caches the
retrieve/verify skeleton keyed by the intent keyword, while the survey step
(task-specific) always runs on the large planner.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.agent_loop import RunRecord
from repro_torch.core.backends import SimulatedBackend
from repro_torch.core.cache import PlanCache
from repro_torch.core.cost_model import CostLedger, estimate_tokens
from repro_torch.core.template import ExecutionLog, make_template
from repro_torch.envs.base import Task, judge

SURVEY_OUT = 700  # initial open-domain survey is long (web browsing notes)
REPLAN_OUT = 450
VERIFY_OUT = 120


@dataclass
class DeepResearchConfig:
    max_steps: int = 12
    cache_capacity: int = 100
    async_cachegen: bool = False
    seed: int = 0


class DeepResearchAgent:
    """APC wired into a survey -> (re-plan -> act)* -> synthesize loop."""

    def __init__(
        self,
        backend: SimulatedBackend,
        ledger: CostLedger,
        cfg: DeepResearchConfig = DeepResearchConfig(),
        cache: Optional[PlanCache] = None,
    ):
        self.be = backend
        self.ledger = ledger
        self.cfg = cfg
        self.cache = cache if cache is not None else PlanCache(cfg.cache_capacity)

    def run_task(self, task: Task) -> RunRecord:
        lat = 0.0
        # 1) survey: always the large planner (task-specific, uncacheable)
        lat += self.ledger.record(
            "large_planner",
            1200 + estimate_tokens(task.query),
            SURVEY_OUT,
        )
        # 2) keyword for the RE-PLANNING skeleton
        kw, ki, ko = self.be.extract_keyword(task)
        lat += self.ledger.record("keyword_extractor", ki, ko)
        t0 = time.perf_counter()
        tpl = self.cache.lookup(kw)
        lookup_s = time.perf_counter() - t0
        lat += lookup_s

        responses: List[Dict[str, Any]] = []
        log = ExecutionLog(task_query=task.query)
        answer = None
        hit = tpl is not None
        steps = 0
        for it in range(self.cfg.max_steps):
            steps += 1
            if hit:
                msg, pi, po = self.be.adapt(task, tpl, responses, round_idx=it)
                lat += self.ledger.record("small_planner", pi, po)
            else:
                msg, pi, po = self.be.plan(task, responses, large=True, round_idx=it)
                lat += self.ledger.record("large_planner", pi, REPLAN_OUT)
            if msg.kind == "answer":
                # verification pass (deep-research agents double-check)
                lat += self.ledger.record("small_planner", 400, VERIFY_OUT)
                log.final_answer = {"answer_text": msg.text, "op": msg.op}
                answer = msg.op.get("value")
                break
            resp, ai, ao = self.be.act(task, msg)
            lat += self.ledger.record("actor", ai, ao)
            responses.append(resp)
            log.append({"message": msg.text, "op": msg.op}, resp)

        gen_s = 0.0
        if not hit and answer is not None:
            gi, go = self.be.cachegen_tokens(log.raw_tokens())
            gen_s = self.ledger.record("cache_generator", gi, go)
            miss_slots = self.be.generalization_misses(task)
            self.cache.insert(kw, make_template(log, kw, task.slots,
                                                miss_slots=miss_slots))
            if not self.cfg.async_cachegen:
                lat += gen_s
        return RunRecord(
            task.id, "deep_research_apc", judge(answer, task.gt_answer), hit,
            kw, steps, answer, self.ledger.total_cost(), lat, lookup_s, gen_s,
        )


def run_deep_research(
    env_name: str = "gaia",
    n: int = 165,
    *,
    use_apc: bool = True,
    seed: int = 0,
) -> Dict[str, Any]:
    """Paper Table 1 GAIA row: Open Deep Research with/without APC."""
    from repro_torch.configs.apc_minion import DEFAULT
    from repro_torch.envs.workloads import get_env

    env = get_env(env_name)
    tasks = env.generate(n, seed=seed)
    be = SimulatedBackend(seed=seed)
    ledger = CostLedger(pricing_map=dict(DEFAULT.pricing))
    cache = PlanCache(100) if use_apc else PlanCache(0)  # capacity-0 = no reuse
    agent = DeepResearchAgent(be, ledger, DeepResearchConfig(seed=seed), cache)
    recs = [agent.run_task(t) for t in tasks]
    return {
        "n": n,
        "accuracy": sum(r.correct for r in recs) / n,
        "cost": ledger.total_cost(),
        "hit_rate": sum(r.hit for r in recs) / n,
        "latency_s": sum(r.latency_s for r in recs),
    }
