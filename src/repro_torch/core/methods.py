"""Agent run-strategies: every evaluation method as a registered class (the
twin of ``repro.core.methods``).

Method map (paper §4.1, plus the beyond-paper ``cascade`` hybrid):

  apc               Alg.1: keyword -> cache -> Alg.2 (hit, small planner
                    adapts the template) / Alg.3 (miss, large planner plans
                    from scratch; the successful log is distilled into the
                    cache)
  accuracy_optimal  always the large planner, no cache
  cost_optimal      always the small planner, no cache
  semantic          GPTCache-style query-similarity cache of final responses
  full_history      keyword cache of raw execution logs used as in-context
                    examples for the small planner
  cascade           exact -> fuzzy -> semantic match pipeline over one plan
                    store: keyword matching first, then query-text
                    similarity against each template's source task; a hit
                    reuses the template (adapted by the small planner)
  speculative       fuzzy near hits execute the adapted template at once
                    while the large planner verifies it round by round;
                    the journal commits, patches the divergent suffix, or
                    rolls back to Algorithm 3 (§4.3 latency hiding)

Importing this module populates the :mod:`repro_torch.memory.registry`.
Every strategy accounts its result through the one :func:`record` helper.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.cache import PlanCache
from repro_torch.core.journal import StepJournal
from repro_torch.core.template import ExecutionLog, PlanTemplate, make_template, rule_filter
from repro_torch.envs.base import Task, judge
from repro_torch.memory.registry import (
    METHOD_REGISTRY,
    AgentMethod,
    get_method_class,
    make_method,
    method_names,
    register_method,
)
from repro_torch.obs import collect


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
    speculated: bool = False,
    spec_outcome: str = "",
):
    """The single RunRecord accounting path shared by every method."""
    from repro_torch.core.agent_loop import RunRecord

    return RunRecord(
        task.id, method, correct, hit, keyword, iterations, answer,
        agent.ledger.total_cost(), latency_s, lookup_s, gen_s,
        speculated, spec_outcome,
    )


class _ScratchMethod(AgentMethod):
    """No cache: every task planned from scratch on one fixed tier."""

    large = True

    def run(self, task: Task):
        agent = self.agent
        answer, iters, _, lat = agent._loop_scratch(task, large=self.large)
        return record(
            agent, task, self.name,
            correct=judge(answer, task.gt_answer), hit=False, keyword="",
            iterations=iters, answer=answer, latency_s=lat,
        )


@register_method("accuracy_optimal")
class AccuracyOptimalMethod(_ScratchMethod):
    large = True


@register_method("cost_optimal")
class CostOptimalMethod(_ScratchMethod):
    large = False


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


@register_method("full_history")
class FullHistoryMethod(AgentMethod):
    """Cache raw execution logs by keyword; replay them unfiltered as
    in-context examples for the small planner."""

    def run(self, task: Task):
        agent = self.agent
        lat = 0.0
        kw, ki, ko = agent.be.extract_keyword(task)
        lat += agent.ledger.record("keyword_extractor", ki, ko)
        t0 = time.perf_counter()
        log: Optional[ExecutionLog] = agent.cache.lookup(kw)
        lookup_s = time.perf_counter() - t0
        lat += lookup_s
        if log is not None:
            # the raw log as in-context example: an unfiltered pseudo-template
            steps = rule_filter(log)
            tpl = PlanTemplate(keyword=kw, steps=steps, source_task=log.task_query)
            # the long history is charged into the small planner's context
            agent.ledger.record("small_planner", log.raw_tokens(), 0)
            answer, iters, l2 = agent._loop_adapt(task, tpl, full_history=True)
            lat += l2
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword=kw,
                iterations=iters, answer=answer, latency_s=lat,
                lookup_s=lookup_s,
            )
        answer, iters, log, l3 = agent._loop_scratch(task, large=True)
        lat += l3
        if answer is not None:
            agent.cache.insert(kw, log)
        return record(
            agent, task, self.name,
            correct=judge(answer, task.gt_answer), hit=False, keyword=kw,
            iterations=iters, answer=answer, latency_s=lat, lookup_s=lookup_s,
        )


@register_method("apc")
class ApcMethod(AgentMethod):
    """Algorithms 1-3. Subclasses override the store hooks to change how
    templates are matched and admitted without touching the accounting."""

    def _lookup(self, kw: str, task: Task) -> Optional[PlanTemplate]:
        return self.agent.cache.lookup(kw)

    def _admit(self, kw: str, task: Task, tpl: PlanTemplate) -> None:
        self.agent.cache.insert(kw, tpl)

    def run(self, task: Task):
        agent = self.agent
        lat = 0.0
        kw, ki, ko = agent.be.extract_keyword(task)
        lat += agent.ledger.record("keyword_extractor", ki, ko)

        t0 = time.perf_counter()
        template = self._lookup(kw, task)
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
        return self._run_miss(task, kw, lat, lookup_s)

    def _run_miss(self, task: Task, kw: str, lat: float, lookup_s: float, **extra):
        """Algorithm 3 (shared with the speculative rollback path)."""
        agent = self.agent
        answer, iters, log, l3 = agent._loop_scratch(task, large=True)
        lat += l3
        gen_s = 0.0
        if answer is not None and log.final_answer is not None:
            gi, go = agent.be.cachegen_tokens(log.raw_tokens())
            gen_s = agent.ledger.record("cache_generator", gi, go)
            miss_slots = agent.be.generalization_misses(task)
            tpl = make_template(log, kw, task.slots, miss_slots=miss_slots)
            self._admit(kw, task, tpl)
            if not agent.cfg.async_cachegen:
                lat += gen_s  # synchronous generation blocks the response
        return record(
            agent, task, self.name,
            correct=judge(answer, task.gt_answer), hit=False, keyword=kw,
            iterations=iters, answer=answer, latency_s=lat,
            lookup_s=lookup_s, gen_s=gen_s, **extra,
        )


@register_method("cascade")
class CascadeMethod(ApcMethod):
    """Exact -> fuzzy -> semantic over one plan store.

    The store's match pipeline resolves a keyword exactly, then by keyword
    similarity, then, with the raw task query as the lookup *context*, by
    similarity against the query each template was distilled from. A
    semantic-stage hit still goes through template adaptation (small
    planner): unlike the ``semantic`` baseline, a similar task reuses the
    plan, not the stale final answer.
    """

    def setup(self) -> None:
        agent = self.agent
        if not agent.cache_external:
            cfg = agent.cfg
            agent.cache = PlanCache(
                capacity=cfg.cache_capacity,
                pipeline=("exact", "fuzzy", "semantic"),
                fuzzy_threshold=cfg.fuzzy_threshold,
                semantic_threshold=cfg.semantic_threshold,
                index_backend=cfg.index_backend,
                eviction=cfg.eviction,
                device=cfg.index_device,
            )

    def _lookup(self, kw, task):
        return self.agent.cache.lookup(kw, context=task.query)

    def _admit(self, kw, task, tpl):
        self.agent.cache.insert(kw, tpl, context=task.query)


@register_method("speculative")
class SpeculativeMethod(ApcMethod):
    """Speculative plan execution on fuzzy near hits (§4.3 latency hiding).

    An exact hit runs Algorithm 2 unchanged. A *near* hit (resolved by the
    fuzzy stage) starts executing the adapted template immediately — every
    actor round journaled as a reversible step — while the large planner
    re-derives the plan round-by-round in the background. When the plans
    agree the journal **commits** (env writes finalized, the adapted
    template promoted under the exact keyword with the
    ``unless_written_since`` token captured at lookup); when they diverge
    at round ``d > 0`` the journal **patches** (the matching executed
    prefix commits, the divergent suffix rolls back and is re-executed by
    the verified planner); divergence at round 0 **rolls back** every
    step and falls back to Algorithm 3. Serving latency on agreement is
    ``max(execute, verify)`` instead of ``verify + execute``.
    """

    def setup(self) -> None:
        agent = self.agent
        if not agent.cache_external:
            cfg = agent.cfg
            agent.cache = PlanCache(
                capacity=cfg.cache_capacity,
                fuzzy=True,
                fuzzy_threshold=cfg.fuzzy_threshold,
                index_backend=cfg.index_backend,
                eviction=cfg.eviction,
                device=cfg.index_device,
            )

    def run(self, task: Task):
        agent = self.agent
        lat = 0.0
        kw, ki, ko = agent.be.extract_keyword(task)
        lat += agent.ledger.record("keyword_extractor", ki, ko)

        t0 = time.perf_counter()
        with collect() as attrib:
            template = self._lookup(kw, task)
        lookup_s = time.perf_counter() - t0
        lat += lookup_s
        if template is None:
            return self._run_miss(task, kw, lat, lookup_s)

        template.uses += 1
        stage = (attrib.get(0) or {}).get("stage", "exact")
        if stage == "exact":  # nothing to verify: plain Algorithm 2
            answer, iters, l2 = agent._loop_adapt(task, template,
                                                  full_history=False)
            lat += l2
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword=kw,
                iterations=iters, answer=answer, latency_s=lat,
                lookup_s=lookup_s,
            )
        return self._run_speculative(task, kw, template, lat, lookup_s)

    # -- the race ------------------------------------------------------

    def _round_responses(self, task: Task, n_rounds: int):
        """Reconstruct per-round actor responses from the journaled
        workspace writes (the speculative execution's real effects)."""
        ws = task.workspace
        out = []
        for r in range(n_rounds):
            prefix = f"r{r}/"
            vals = {k[len(prefix):]: ws.read(k)
                    for k in ws.keys() if k.startswith(prefix)}
            out.append({"values": vals})
        return out

    def _run_speculative(self, task: Task, kw: str, template, lat: float,
                         lookup_s: float):
        agent = self.agent
        journal = StepJournal()
        token = agent.cache.now()

        # 1) execute the adapted plan now; steps stay open in the journal
        answer, iters, exec_lat = agent._loop_adapt(
            task, template, full_history=False, journal=journal)
        executed = journal.open_steps()  # actor rounds speculatively run
        responses = self._round_responses(task, executed)

        # promotion of the near-hit under the exact keyword is deferred:
        # it lands only if the verifier agrees end-to-end, and the token
        # captured at lookup keeps a late commit from clobbering a newer
        # template (insert-if-newer, §4.3 admission race)
        admit = journal.begin_step("spec-admit")
        admit.on_commit(lambda: agent.cache.insert_batch(
            [(kw, template)], unless_written_since=token))

        # 2) verify in the background: the large planner re-derives the
        #    plan round-by-round against the speculative retrievals
        verify_lat = 0.0
        divergence = executed  # rounds 0..divergence-1 match
        for r in range(executed):
            msg, pi, po = agent.be.plan(task, responses[:r], large=True,
                                        round_idx=r)
            verify_lat += agent.ledger.record("large_planner", pi, po)
            planned = sorted(f for f in msg.op.get("retrieve", [])
                             if f in task.context)
            ran = sorted(responses[r]["values"])
            if msg.kind != "message" or planned != ran:
                divergence = r
                break

        if divergence >= executed:  # ---- plans agree: COMMIT
            journal.commit()
            lat += max(exec_lat, verify_lat)
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword=kw,
                iterations=iters, answer=answer, latency_s=lat,
                lookup_s=lookup_s, speculated=True, spec_outcome="commit",
            )

        if divergence > 0:  # ---- PATCH: keep the matching prefix
            journal.patch(keep=divergence)
            prefix_lat = exec_lat * divergence / max(1, iters)
            answer, suffix_iters, _log, suffix_lat = agent._loop_scratch(
                task, large=True, journal=journal,
                responses=responses[:divergence], start_round=divergence)
            journal.commit()  # the re-executed suffix is verified work
            lat += max(prefix_lat, verify_lat) + suffix_lat
            return record(
                agent, task, self.name,
                correct=judge(answer, task.gt_answer), hit=True, keyword=kw,
                iterations=divergence + suffix_iters, answer=answer,
                latency_s=lat, lookup_s=lookup_s,
                speculated=True, spec_outcome="patch",
            )

        # ---- ROLLBACK: divergence at round 0, nothing reusable
        journal.rollback()
        lat += verify_lat  # the loss: verification time was spent
        return self._run_miss(task, kw, lat, lookup_s,
                              speculated=True, spec_outcome="rollback")


__all__ = [
    "METHOD_REGISTRY",
    "AccuracyOptimalMethod",
    "AgentMethod",
    "ApcMethod",
    "CascadeMethod",
    "CostOptimalMethod",
    "FullHistoryMethod",
    "SemanticMethod",
    "SpeculativeMethod",
    "get_method_class",
    "make_method",
    "method_names",
    "record",
    "register_method",
]
