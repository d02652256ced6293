"""Agent run-strategies (trimmed copy of ``repro.core.methods``): the
registered methods and the one ``record`` accounting path.

  apc       Alg.1: keyword -> cache -> Alg.2 (hit, small planner adapts the
            template) / Alg.3 (miss, large planner plans from scratch; the
            successful log is distilled into the cache)
  semantic  GPTCache-style query-similarity cache of final responses

The reference's other methods (accuracy_optimal, cost_optimal,
full_history, cascade, speculative) are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Type

from repro_torch.core.cache import PlanCache
from repro_torch.core.template import PlanTemplate, make_template
from repro_torch.envs.base import Task, judge


class AgentMethod:
    """One run strategy bound to one agent deployment."""

    name = ""  # set by register_method

    def __init__(self, agent: Any):
        self.agent = agent
        self.setup()

    def setup(self) -> None:
        """Runs once at agent construction (before the agent's own cache
        is built)."""

    def run(self, task: Task):
        raise NotImplementedError


METHOD_REGISTRY: Dict[str, Type[AgentMethod]] = {}


def register_method(name: str):
    """Class decorator: register an :class:`AgentMethod` under ``name``."""

    def deco(cls: Type[AgentMethod]) -> Type[AgentMethod]:
        cls.name = name
        METHOD_REGISTRY[name] = cls
        return cls

    return deco


def make_method(name: str, agent: Any) -> AgentMethod:
    try:
        cls = METHOD_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered: {sorted(METHOD_REGISTRY)}"
        ) from None
    return cls(agent)


def record(
    agent,
    task: Task,
    method: str,
    *,
    correct: bool,
    hit: bool,
    keyword: str,
    iterations: int,
    answer: Optional[float],
    latency_s: float,
    lookup_s: float = 0.0,
    gen_s: float = 0.0,
):
    """The single RunRecord accounting path."""
    from repro_torch.core.agent_loop import RunRecord

    return RunRecord(
        task.id, method, correct, hit, keyword, iterations, answer,
        agent.ledger.total_cost(), latency_s, lookup_s, gen_s,
    )


@register_method("semantic")
class SemanticMethod(AgentMethod):
    """GPTCache semantics: cache final responses keyed by the query, served
    on query-text similarity, through a PlanCache with an
    ``exact -> semantic`` match pipeline."""

    def setup(self) -> None:
        cfg = self.agent.cfg
        self.store: PlanCache = PlanCache(
            capacity=1_000_000,  # the baseline never evicts
            pipeline=("exact", "semantic"),
            semantic_threshold=cfg.semantic_threshold,
            index_backend=cfg.index_backend,
            device=cfg.index_device,
        )

    def run(self, task: Task):
        agent = self.agent
        t0 = time.perf_counter()
        hit_val = self.store.lookup(task.query)
        lookup_s = time.perf_counter() - t0
        if hit_val is not None:
            # cached final response returned verbatim (GPTCache semantics):
            # correct only if the numeric answer transfers to THIS task
            answer = hit_val[1]
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword="",
                iterations=0, answer=answer, latency_s=lookup_s,
                lookup_s=lookup_s,
            )
        answer, iters, _, lat = agent._loop_scratch(task, large=True)
        self.store.insert(task.query, (task.query, answer))
        return record(
            agent, task, self.name,
            correct=judge(answer, task.gt_answer), hit=False, keyword="",
            iterations=iters, answer=answer, latency_s=lat + lookup_s,
            lookup_s=lookup_s,
        )


@register_method("apc")
class ApcMethod(AgentMethod):
    """Algorithms 1-3."""

    def run(self, task: Task):
        agent = self.agent
        lat = 0.0
        kw, ki, ko = agent.be.extract_keyword(task)
        lat += agent.ledger.record("keyword_extractor", ki, ko)

        t0 = time.perf_counter()
        template: Optional[PlanTemplate] = agent.cache.lookup(kw)
        lookup_s = time.perf_counter() - t0
        lat += lookup_s

        if template is not None:  # ---- Algorithm 2: cache hit
            template.uses += 1
            answer, iters, l2 = agent._loop_adapt(task, template, full_history=False)
            lat += l2
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword=kw,
                iterations=iters, answer=answer, latency_s=lat,
                lookup_s=lookup_s,
            )

        # ---- Algorithm 3: cache miss
        answer, iters, log, l3 = agent._loop_scratch(task, large=True)
        lat += l3
        gen_s = 0.0
        if answer is not None and log.final_answer is not None:
            gi, go = agent.be.cachegen_tokens(log.raw_tokens())
            gen_s = agent.ledger.record("cache_generator", gi, go)
            miss_slots = agent.be.generalization_misses(task)
            tpl = make_template(log, kw, task.slots, miss_slots=miss_slots)
            agent.cache.insert(kw, tpl)
            if not agent.cfg.async_cachegen:
                lat += gen_s  # synchronous generation blocks the response
        return record(
            agent, task, self.name,
            correct=judge(answer, task.gt_answer), hit=False, keyword=kw,
            iterations=iters, answer=answer, latency_s=lat,
            lookup_s=lookup_s, gen_s=gen_s,
        )
