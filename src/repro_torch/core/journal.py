"""Step journal for the agent loop's env effects (trimmed copy of
``repro.core.journal``).

Every actor round's workspace writes are recorded in a step as
compensation closures (``step.applied(ws.write(...))``); the agent loop
commits each step as it finishes. The speculative rollback/patch half of
the reference journal is not on the ``apc`` path and is not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class JournalStep:
    """One step: the compensations of its eagerly-applied effects."""

    index: int
    undos: List[Callable[[], None]] = field(default_factory=list)
    label: str = ""

    def applied(self, undo: Callable[[], None]) -> None:
        """Record an eagerly-applied effect via its compensation closure."""
        self.undos.append(undo)


class StepJournal:
    """Ordered journal of steps with prefix-commit semantics."""

    def __init__(self) -> None:
        self._steps: List[JournalStep] = []
        self._committed = 0  # steps [0, _committed) are final

    def begin_step(self, label: str = "") -> JournalStep:
        step = JournalStep(index=len(self._steps), label=label)
        self._steps.append(step)
        return step

    def open_steps(self) -> int:
        """Steps recorded but not committed."""
        return len(self._steps) - self._committed

    def commit(self) -> int:
        """Commit every open step. Returns #steps committed."""
        n = self.open_steps()
        self._committed += n
        return n
