"""Plan templates: extraction from execution logs (rule filter + lightweight
generalization filter) — paper Fig. 2(c) and §3.1 step (c).

A *plan* in this framework is a structured planner->actor message:
    {"message": <text>, "op": {"retrieve": [...fields], "scope": {...}}}
or the terminal
    {"answer": <text>, "op": {"compute": <expr>}}

Template generation (cache miss path, Algorithm 3 line 12):
  1. rule-based filter: project the raw execution log onto the
     message->output->...->answer skeleton, dropping planner chain-of-thought
     and actor verbosity (paper: "discarding irrelevant details");
  2. generalization filter (the paper uses GPT-4o-mini): replace
     context-specific slot values (entity names, fiscal years, numbers) with
     named placeholders so the template transfers across tasks.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class PlanStep:
    kind: str  # "message" | "output" | "answer"
    content: str
    op: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "content": self.content, "op": self.op}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PlanStep":
        """The inverse of ``to_json`` (the cold tier's segment decoder)."""
        return cls(d["kind"], d["content"], d["op"])


@dataclass
class PlanTemplate:
    keyword: str
    steps: List[PlanStep]
    source_task: str = ""
    uses: int = 0

    def message_steps(self) -> List[PlanStep]:
        return [s for s in self.steps if s.kind == "message"]

    def answer_step(self) -> Optional[PlanStep]:
        for s in self.steps:
            if s.kind == "answer":
                return s
        return None

    def n_rounds(self) -> int:
        return len(self.message_steps())

    def size_tokens(self) -> int:
        from repro_torch.core.cost_model import estimate_tokens

        return sum(estimate_tokens(s.content) for s in self.steps) + 20


@dataclass
class ExecutionLog:
    """Raw Plan-Act trace (Algorithm 3's ``log``)."""

    task_query: str
    entries: List[Dict[str, Any]] = field(default_factory=list)  # {plan, response}
    final_answer: Optional[Dict[str, Any]] = None

    def append(self, plan: Dict[str, Any], response: Dict[str, Any]) -> None:
        self.entries.append({"plan": plan, "response": response})

    def raw_tokens(self) -> int:
        from repro_torch.core.cost_model import estimate_tokens

        n = estimate_tokens(self.task_query)
        for e in self.entries:
            n += estimate_tokens(str(e["plan"])) + estimate_tokens(str(e["response"]))
        if self.final_answer:
            n += estimate_tokens(str(self.final_answer))
        return n


# ---------------------------------------------------------------------------
# Step 1: rule-based filter
# ---------------------------------------------------------------------------


def rule_filter(log: ExecutionLog) -> List[PlanStep]:
    """Keep the message/output/answer skeleton, drop reasoning prose.

    Planner messages carry a structured ``op`` plus prose; we keep the op and
    the first sentence of the message (the imperative part). Actor outputs
    keep only the structured values (what the next plan conditions on).
    """
    steps: List[PlanStep] = []
    for e in log.entries:
        plan = e["plan"]
        msg = plan.get("message", "")
        first_sentence = msg.split(". ")[0][:300]
        steps.append(PlanStep("message", first_sentence, plan.get("op")))
        resp = e["response"]
        keys = sorted(resp.get("values", {}).keys()) if isinstance(resp, dict) else []
        steps.append(PlanStep("output", "values: " + ", ".join(keys), None))
    if log.final_answer is not None:
        fa = log.final_answer
        steps.append(PlanStep("answer", fa.get("answer_text", "")[:200], fa.get("op")))
    return steps


# ---------------------------------------------------------------------------
# Step 2: generalization filter (lightweight-LM role, deterministic here)
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"(?<![\w{])[-+]?\d[\d,]*(?:\.\d+)?%?(?![\w}])")


def generalize(
    steps: List[PlanStep],
    slots: Dict[str, str],
    *,
    miss_slots: Optional[List[str]] = None,
) -> List[PlanStep]:
    """Replace slot values with {slot} placeholders and scrub free numbers.

    ``miss_slots`` models generalization errors of the lightweight filter
    model (a slot it failed to abstract stays baked into the template — the
    template then mis-transfers, which shows up as a cache-hit accuracy
    cost; the simulated backend injects these at its error rate).
    """
    miss = set(miss_slots or [])
    # longest-first so "Best Buy" is replaced before "Best"
    items = sorted(slots.items(), key=lambda kv: -len(str(kv[1])))
    out: List[PlanStep] = []
    for s in steps:
        content = s.content
        op = _deep_copy_op(s.op)
        for name, val in items:
            if name in miss:
                continue
            sval = str(val)
            if not sval:
                continue
            content = content.replace(sval, "{%s}" % name)
            op = _op_replace(op, sval, "{%s}" % name)
        if s.kind != "answer":
            content = _NUM_RE.sub("{N}", content)
        out.append(PlanStep(s.kind, content, op))
    return out


def _deep_copy_op(op):
    if op is None:
        return None
    if isinstance(op, dict):
        return {k: _deep_copy_op(v) for k, v in op.items()}
    if isinstance(op, list):
        return [_deep_copy_op(v) for v in op]
    return op


def _op_replace(op, old: str, new: str):
    if op is None:
        return None
    if isinstance(op, dict):
        return {k: _op_replace(v, old, new) for k, v in op.items()}
    if isinstance(op, list):
        return [_op_replace(v, old, new) for v in op]
    if isinstance(op, str):
        return op.replace(old, new)
    return op


def make_template(
    log: ExecutionLog,
    keyword: str,
    slots: Dict[str, str],
    *,
    miss_slots: Optional[List[str]] = None,
) -> PlanTemplate:
    steps = rule_filter(log)
    steps = generalize(steps, slots, miss_slots=miss_slots)
    src = log.task_query
    for name, val in sorted(slots.items(), key=lambda kv: -len(str(kv[1]))):
        src = src.replace(str(val), "{%s}" % name)
    return PlanTemplate(keyword=keyword, steps=steps, source_task=src[:300])


# ---------------------------------------------------------------------------
# Template instantiation (used by the backends' adapt())
# ---------------------------------------------------------------------------


def instantiate(tpl_text_or_op, slots: Dict[str, str]):
    """Fill {slot} placeholders from the *current* task's slot bindings."""
    if tpl_text_or_op is None:
        return None
    if isinstance(tpl_text_or_op, dict):
        return {k: instantiate(v, slots) for k, v in tpl_text_or_op.items()}
    if isinstance(tpl_text_or_op, list):
        return [instantiate(v, slots) for v in tpl_text_or_op]
    if isinstance(tpl_text_or_op, str):
        out = tpl_text_or_op
        for name, val in slots.items():
            out = out.replace("{%s}" % name, str(val))
        return out
    return tpl_text_or_op
