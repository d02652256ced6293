"""Executable agent environments.

Each env mirrors one of the paper's workloads with *machine-checkable*
tasks: a task carries a context document (field -> value), an intent (which
canonical multi-round plan solves it), slot bindings (entity names, years),
and a ground-truth answer computed by the same interpreter the actor uses.
Accuracy in every benchmark is therefore measured, not assumed.

The plan DSL the actor interprets:
    {"retrieve": [field, ...], "scope": {slot: value}}   -> {"values": {...}}
    {"compute": "<arithmetic over names a,b,c...>"}       -> final answer
"""

from __future__ import annotations

import hashlib
import math
import random
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class Workspace:
    """Mutable env-side state with a compensating-write protocol.

    Every write returns the compensation closure that restores the prior
    state (previous value, or absence), which callers hand to a
    :class:`repro_torch.core.journal.StepJournal` step: what makes
    speculative plan execution reversible. Single-owner (one workspace per
    task, driven from one thread), so it takes no lock.
    """

    _ABSENT = object()

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}

    def _restore(self, key: str, prior: Any) -> Callable[[], None]:
        def compensation() -> None:
            if prior is Workspace._ABSENT:
                self._data.pop(key, None)
            else:
                self._data[key] = prior

        return compensation

    def write(self, key: str, value: Any) -> Callable[[], None]:
        """Apply ``key = value`` eagerly; return the undo closure."""
        prior = self._data.get(key, Workspace._ABSENT)
        self._data[key] = value
        return self._restore(key, prior)

    def read(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self) -> List[str]:
        return sorted(self._data)


@dataclass(frozen=True)
class IntentSpec:
    id: str
    keyword: str  # canonical intent keyword (cache key)
    query_template: str  # with {slot} placeholders
    rounds: List[List[str]]  # per Plan round: fields to retrieve
    expr: str  # final computation over names a,b,c,... in retrieval order
    paraphrase_keywords: Tuple[str, ...] = ()  # miss-extraction variants

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def all_fields(self) -> List[str]:
        return [f for r in self.rounds for f in r]


@dataclass
class Task:
    id: str
    env: str
    query: str
    intent: IntentSpec
    slots: Dict[str, str]
    context: Dict[str, float]  # the document/table the ACTOR sees
    distractors: List[str]  # plausible wrong field names
    gt_answer: float
    context_tokens: int  # token length of the context document
    # env-side effect surface: actor rounds record their retrieved values
    # here through the journal, so speculative rounds can be rolled back
    workspace: Workspace = field(default_factory=Workspace)


def det_rng(*parts: Any) -> random.Random:
    """Deterministic RNG from arbitrary key parts (reproducible runs)."""
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(), digest_size=8)
    return random.Random(int.from_bytes(h.digest(), "little"))


# ---------------------------------------------------------------------------
# Plan interpreter (the actor's execution semantics)
# ---------------------------------------------------------------------------

_EXPR_RE = re.compile(r"^[\sa-z0-9+\-*/().,_]*$")


def execute_retrieve(op: Dict[str, Any], context: Dict[str, float]) -> Dict[str, float]:
    vals = {}
    for f in op.get("retrieve", []):
        if f in context:
            vals[f] = context[f]
    return vals


def execute_compute(expr: str, bindings: Dict[str, float]) -> Optional[float]:
    if not _EXPR_RE.match(expr):
        return None
    env = {k: float(v) for k, v in bindings.items()}
    env.update({"abs": abs, "min": min, "max": max, "sqrt": math.sqrt})
    try:
        return float(eval(expr, {"__builtins__": {}}, env))  # noqa: S307 sandboxed
    except Exception:
        return None


def gt_for(intent: IntentSpec, context: Dict[str, float]) -> Optional[float]:
    names = "abcdefghij"
    bindings = {}
    for i, f in enumerate(intent.all_fields):
        if f not in context:
            return None
        bindings[names[i]] = context[f]
    return execute_compute(intent.expr, bindings)


# ---------------------------------------------------------------------------
# Judge (paper B.4.2 tolerance rules, deterministic)
# ---------------------------------------------------------------------------


def judge(answer: Optional[float], gt: float) -> bool:
    """Paper-style numeric grading: small rounding errors and unit slips
    (x1000 / x0.001 / percent-vs-fraction) are accepted; sign errors and
    order-of-magnitude mistakes are not."""
    if answer is None or not math.isfinite(answer):
        return False
    for scale in (1.0, 100.0, 0.01, 1000.0, 0.001):
        a = answer * scale
        if gt == 0:
            if abs(a) < 1e-6:
                return True
            continue
        if (a >= 0) == (gt >= 0) and abs(a - gt) / max(abs(gt), 1e-12) < 0.02:
            return True
    return False


# ---------------------------------------------------------------------------
# Env base
# ---------------------------------------------------------------------------


class AgentEnv:
    """Base: subclasses define intents(), entities, and context generation."""

    name = "base"
    context_tokens_range = (400, 1200)
    value_range = (10.0, 50_000.0)
    n_distractor_fields = 12

    def intents(self) -> List[IntentSpec]:
        raise NotImplementedError

    def entities(self) -> Dict[str, List[str]]:
        """slot name -> possible values."""
        raise NotImplementedError

    # -- task generation ----------------------------------------------------

    def generate(self, n: int, seed: int = 0) -> List[Task]:
        intents = self.intents()
        ents = self.entities()
        tasks = []
        for i in range(n):
            rng = det_rng(self.name, seed, i)
            intent = rng.choice(intents)
            slots = {k: rng.choice(v) for k, v in ents.items()}
            context, distractors = self._make_context(intent, rng)
            gt = gt_for(intent, context)
            # regenerate degenerate contexts (div-by-~0 etc.)
            tries = 0
            while (gt is None or not math.isfinite(gt) or abs(gt) > 1e12) and tries < 5:
                context, distractors = self._make_context(intent, rng)
                gt = gt_for(intent, context)
                tries += 1
            query = intent.query_template.format(**slots)
            ctok = rng.randint(*self.context_tokens_range)
            tasks.append(
                Task(
                    id=f"{self.name}-{seed}-{i}",
                    env=self.name,
                    query=query,
                    intent=intent,
                    slots=slots,
                    context=context,
                    distractors=distractors,
                    gt_answer=gt,
                    context_tokens=ctok,
                )
            )
        return tasks

    def _make_context(self, intent: IntentSpec, rng: random.Random):
        context: Dict[str, float] = {}
        for f in intent.all_fields:
            context[f] = round(rng.uniform(*self.value_range), 2)
        distractors = []
        for j in range(self.n_distractor_fields):
            name = f"{self.name}_aux_metric_{rng.randint(0, 999)}_{j}"
            context[name] = round(rng.uniform(*self.value_range), 2)
            distractors.append(name)
        return context, distractors
