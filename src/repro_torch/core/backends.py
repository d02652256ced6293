"""LM backends for the APC control plane.

``SimulatedBackend`` is a deterministic behavioral model of each LM role:
it produces *real structured plans* against the executable envs (so accuracy
is measured end-to-end by the env judge), with per-role quality knobs
calibrated to the paper's sensitivity tables (Tables 9-11) — e.g. the large
planner plans correctly ~95% of the time, the small planner ~57%, template
adaptation ~93%. Failures are real failure modes (wrong field retrieved,
wrong scope, unfilled placeholder), not coin-flip labels.

``TorchBackend`` (serving/torch_backend.py) runs actual torch models from the zoo
for the data-plane path; content-level behavior still comes from the
simulated layer (random weights produce no usable text), which is the
standard synthetic-workload methodology for serving systems.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from repro_torch.core.cost_model import estimate_tokens
from repro_torch.core.template import PlanTemplate, instantiate
from repro_torch.envs.base import Task, det_rng, execute_compute, execute_retrieve


@dataclass(frozen=True)
class QualityProfile:
    """Per-CALL success probabilities. A query samples ~2.4 calls (retrieval
    rounds + answer round), so per-query accuracies compose: e.g.
    0.975^2.4 * 0.985^1.4 ~ 0.91 (paper's accuracy-optimal FinanceBench)."""

    p_plan_large: float = 0.975  # correct from-scratch plan, large planner
    p_plan_small: float = 0.66  # correct from-scratch plan, small planner
    p_adapt: float = 0.945  # correct template adaptation, small planner
    p_adapt_fullhist: float = 0.81  # adaptation from unfiltered history
    p_actor: float = 0.985  # actor retrieves values faithfully
    p_keyword: float = 0.96  # canonical keyword extracted
    p_generalize: float = 0.93  # cache-gen filter abstracts every slot


@dataclass(frozen=True)
class TokenProfile:
    """Per-call token counts (see EXPERIMENTS.md §Calibration)."""

    planner_sys: int = 1500
    planner_out_large: int = 800  # chain-of-thought + retrieval message
    planner_out_small: int = 680
    answer_out_large: int = 260  # terminal answer call is shorter
    answer_out_small: int = 220
    adapt_out: int = 130
    adapt_answer_out: int = 90
    adapt_fullhist_out: int = 180
    actor_excerpt: int = 1200  # actor reads a retrieved excerpt, not the full doc
    actor_out: int = 90
    keyword_in_extra: int = 60
    keyword_out: int = 8
    cachegen_in: int = 500
    cachegen_out: int = 200


DEFAULT_QUALITY = QualityProfile()
DEFAULT_TOKENS = TokenProfile()


@dataclass
class PlanMsg:
    """A planner->actor message (or terminal answer)."""

    kind: str  # "message" | "answer"
    text: str
    op: Dict[str, Any]


class SimulatedBackend:
    """All five LM roles, deterministic given (seed, task id, call site)."""

    def __init__(
        self,
        quality: QualityProfile = DEFAULT_QUALITY,
        tokens: TokenProfile = DEFAULT_TOKENS,
        seed: int = 0,
    ):
        self.q = quality
        self.t = tokens
        self.seed = seed

    # ------------------------------------------------------------------
    # keyword extraction (paper B.4.3)
    # ------------------------------------------------------------------

    def extract_keyword(self, task: Task) -> Tuple[str, int, int]:
        """Returns (keyword, in_tokens, out_tokens)."""
        rng = det_rng(self.seed, task.id, "keyword")
        intent = task.intent
        if rng.random() < self.q.p_keyword or not intent.paraphrase_keywords:
            kw = intent.keyword
        else:
            kw = rng.choice(list(intent.paraphrase_keywords))
        inp = estimate_tokens(task.query) + self.t.keyword_in_extra
        return kw, inp, self.t.keyword_out

    # ------------------------------------------------------------------
    # planning from scratch (large or small planner)
    # ------------------------------------------------------------------

    def plan(
        self,
        task: Task,
        responses: List[Dict[str, Any]],
        *,
        large: bool,
        round_idx: int,
    ) -> Tuple[PlanMsg, int, int]:
        """Next plan message, or the final answer once retrievals suffice."""
        intent = task.intent
        p_ok = self.q.p_plan_large if large else self.q.p_plan_small
        rng = det_rng(self.seed, task.id, "plan", large, round_idx)
        correct = rng.random() < p_ok

        if round_idx < intent.n_rounds:
            fields = list(intent.rounds[round_idx])
            if not correct:
                fields = self._corrupt_fields(fields, task, rng)
            msg = PlanMsg(
                kind="message",
                text=(
                    f"Please provide {', '.join(fields)} for "
                    f"{task.slots.get('company', task.slots.get('student', ''))} "
                    f"from the provided context."
                ),
                op={"retrieve": fields, "scope": dict(task.slots)},
            )
        else:
            msg = self._answer_from(task, responses, correct)
        inp = (
            self.t.planner_sys
            + estimate_tokens(task.query)
            + sum(estimate_tokens(str(r)) for r in responses)
        )
        if msg.kind == "answer":
            out = self.t.answer_out_large if large else self.t.answer_out_small
        else:
            out = self.t.planner_out_large if large else self.t.planner_out_small
        return msg, inp, out

    def _corrupt_fields(self, fields, task: Task, rng) -> List[str]:
        bad = list(fields)
        i = rng.randrange(len(bad))
        pool = task.distractors or ["unknown_metric"]
        bad[i] = rng.choice(pool)
        return bad

    def _answer_from(self, task: Task, responses, correct: bool) -> PlanMsg:
        names = "abcdefghij"
        bindings: Dict[str, float] = {}
        idx = 0
        for r in responses:
            for f in task.intent.all_fields:
                if f in r.get("values", {}) and names[idx : idx + 1]:
                    bindings[names[idx]] = r["values"][f]
                    idx += 1
        expr = task.intent.expr
        if not correct:
            rng = det_rng(self.seed, task.id, "expr")
            expr = rng.choice(["a", "a * b" if "b" in bindings else "a * 2", "a + 1"])
        val = execute_compute(expr, bindings)
        return PlanMsg(
            kind="answer",
            text=f"The answer is {val}.",
            op={"compute": expr, "value": val},
        )

    # ------------------------------------------------------------------
    # template adaptation (small planner on cache hit; paper B.4.5)
    # ------------------------------------------------------------------

    def adapt(
        self,
        task: Task,
        template: PlanTemplate,
        responses: List[Dict[str, Any]],
        *,
        round_idx: int,
        full_history: bool = False,
    ) -> Tuple[PlanMsg, int, int]:
        p_ok = self.q.p_adapt_fullhist if full_history else self.q.p_adapt
        rng = det_rng(self.seed, task.id, "adapt", round_idx, full_history)
        correct = rng.random() < p_ok

        msgs = template.message_steps()
        if round_idx < len(msgs):
            step = msgs[round_idx]
            op = instantiate(step.op, task.slots) or {}
            fields = [f for f in op.get("retrieve", []) if "{" not in f]
            if not correct and fields:
                fields = self._corrupt_fields(fields, task, rng)
            msg = PlanMsg(
                kind="message",
                text=instantiate(step.content, task.slots),
                op={"retrieve": fields, "scope": dict(task.slots)},
            )
        else:
            ans = template.answer_step()
            expr = (ans.op or {}).get("compute", task.intent.expr) if ans else task.intent.expr
            if "{" in str(expr):  # un-generalized garbage leaked into template
                correct = False
                expr = "a"
            if not correct:
                expr = rng.choice(["a", "a + 1"])
            names = "abcdefghij"
            bindings, idx = {}, 0
            for r in responses:
                for f in task.intent.all_fields:
                    if f in r.get("values", {}):
                        bindings[names[idx]] = r["values"][f]
                        idx += 1
            val = execute_compute(str(expr), bindings)
            msg = PlanMsg("answer", f"The answer is {val}.", {"compute": expr, "value": val})
        inp = (
            estimate_tokens(task.query)
            + (template.size_tokens() if not full_history else 0)
            + sum(estimate_tokens(str(r)) for r in responses)
            + 120
        )
        if full_history:
            out = self.t.adapt_fullhist_out
        else:
            out = self.t.adapt_answer_out if msg.kind == "answer" else self.t.adapt_out
        return msg, inp, out

    # ------------------------------------------------------------------
    # actor (executes retrieval plans against the context)
    # ------------------------------------------------------------------

    def act(self, task: Task, plan: PlanMsg) -> Tuple[Dict[str, Any], int, int]:
        rng = det_rng(self.seed, task.id, "act", plan.text[:40])
        values = execute_retrieve(plan.op, task.context)
        if values and rng.random() > self.q.p_actor:
            k = rng.choice(list(values))
            values[k] = values[k] * rng.choice([10.0, 0.1, -1.0])  # mis-read
        resp = {"values": values}
        inp = min(task.context_tokens, self.t.actor_excerpt) + estimate_tokens(plan.text)
        return resp, inp, self.t.actor_out

    # ------------------------------------------------------------------
    # cache generation filter (lightweight LM; slot-abstraction errors)
    # ------------------------------------------------------------------

    def generalization_misses(self, task: Task) -> List[str]:
        rng = det_rng(self.seed, task.id, "gen")
        if rng.random() < self.q.p_generalize:
            return []
        slots = list(task.slots)
        return [rng.choice(slots)] if slots else []

    def cachegen_tokens(self, raw_tokens: int) -> Tuple[int, int]:
        return min(raw_tokens, self.t.cachegen_in) + 150, self.t.cachegen_out
