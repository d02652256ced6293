"""The Plan-Act agent loop: Algorithms 1-3 from the paper (trimmed copy of
``repro.core.agent_loop``).

``PlanActAgent`` owns one serving deployment (backend + plan cache +
ledger) and the two inner loops the ``apc`` method composes:

* ``_loop_scratch`` — plan from scratch on the large/small planner
  (Algorithm 3);
* ``_loop_adapt``   — adapt a cached template with the small planner
  (Algorithm 2).

``run_task`` dispatches to the method registered in
:mod:`repro_torch.core.methods`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.backends import SimulatedBackend
from repro_torch.core.cache import PlanCache
from repro_torch.core.cost_model import CostLedger
from repro_torch.core.journal import StepJournal
from repro_torch.core.template import ExecutionLog, PlanTemplate
from repro_torch.envs.base import Task


@dataclass
class RunRecord:
    task_id: str
    method: str
    correct: bool
    hit: bool
    keyword: str
    iterations: int
    answer: Optional[float]
    cost: float
    latency_s: float
    cache_lookup_s: float = 0.0
    cache_gen_s: float = 0.0
    speculated: bool = False  # the port has no speculative method
    spec_outcome: str = ""


@dataclass
class AgentConfig:
    method: str = "apc"
    max_iterations: int = 10
    cache_capacity: int = 100
    fuzzy: bool = False
    fuzzy_threshold: float = 0.8
    semantic_threshold: float = 0.85
    index_backend: str = "auto"  # repro_torch.index backend for fuzzy/semantic search
    index_device: Optional[str] = None  # where that index searches; None = CUDA
    async_cachegen: bool = False  # beyond-paper: don't block on cache writes


class PlanActAgent:
    """One agent serving deployment: backend + cache + ledger."""

    def __init__(
        self,
        backend: SimulatedBackend,
        ledger: CostLedger,
        config: AgentConfig,
        cache: Optional[PlanCache] = None,
    ):
        from repro_torch.core.methods import make_method

        self.be = backend
        self.ledger = ledger
        self.cfg = config
        # NB: `cache is not None` — an empty PlanCache is falsy
        self.cache: Optional[PlanCache] = cache
        self._method = make_method(config.method, self)
        if self.cache is None:
            self.cache = PlanCache(
                capacity=config.cache_capacity,
                fuzzy=config.fuzzy,
                fuzzy_threshold=config.fuzzy_threshold,
                index_backend=config.index_backend,
                device=config.index_device,
            )

    # ==================================================================
    # Algorithm 1: end-to-end (registry dispatch, no method branching)
    # ==================================================================

    def run_task(self, task: Task) -> RunRecord:
        return self._method.run(task)

    # ==================================================================
    # inner loops
    # ==================================================================

    def _record_act_effects(
        self, task: Task, journal: StepJournal, round_idx: int,
        resp: Dict[str, Any],
    ) -> None:
        """Journal one actor round's env writes (reversible workspace puts)."""
        step = journal.begin_step(f"round-{round_idx}")
        ws = task.workspace
        for name in sorted(resp.get("values", {})):
            step.applied(ws.write(f"r{round_idx}/{name}", resp["values"][name]))

    def _loop_scratch(
        self, task: Task, *, large: bool,
    ) -> Tuple[Optional[float], int, ExecutionLog, float]:
        """Plan from scratch."""
        role = "large_planner" if large else "small_planner"
        log = ExecutionLog(task_query=task.query)
        responses: List[Dict[str, Any]] = []
        journal = StepJournal()
        lat = 0.0
        answer = None
        iters = 0
        for it in range(self.cfg.max_iterations):
            iters += 1
            msg, pi, po = self.be.plan(task, responses, large=large, round_idx=it)
            lat += self.ledger.record(role, pi, po)
            if msg.kind == "answer":
                log.final_answer = {"answer_text": msg.text, "op": msg.op}
                answer = msg.op.get("value")
                break
            resp, ai, ao = self.be.act(task, msg)
            lat += self.ledger.record("actor", ai, ao)
            responses.append(resp)
            log.append({"message": msg.text, "op": msg.op}, resp)
            self._record_act_effects(task, journal, it, resp)
            journal.commit()  # non-speculative: finalize per step
        return answer, iters or self.cfg.max_iterations, log, lat

    def _loop_adapt(
        self, task: Task, template: PlanTemplate, *, full_history: bool,
    ) -> Tuple[Optional[float], int, float]:
        responses: List[Dict[str, Any]] = []
        lat = 0.0
        journal = StepJournal()
        for it in range(self.cfg.max_iterations):
            msg, pi, po = self.be.adapt(
                task, template, responses, round_idx=it, full_history=full_history
            )
            lat += self.ledger.record("small_planner", pi, po)
            if msg.kind == "answer":
                return msg.op.get("value"), it + 1, lat
            resp, ai, ao = self.be.act(task, msg)
            lat += self.ledger.record("actor", ai, ao)
            responses.append(resp)
            self._record_act_effects(task, journal, it, resp)
            journal.commit()
        return None, self.cfg.max_iterations, lat
