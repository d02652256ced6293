"""Step-level undo/commit journal for speculative plan execution (the twin
of ``repro.core.journal``).

Speculation (the paper's §4.3 latency hiding) executes an adapted cached
plan before the planner has confirmed it. Every env effect of a speculative
step is therefore either

* **applied eagerly with a compensation** — workspace ``write()`` returns
  the undo closure the journal keeps; or
* **deferred until commit** — cache admissions and metric increments run
  only when the verifier agrees, so a rolled-back step never leaks a
  template into the store or a count into the metrics. A deferred admission
  captures its ``unless_written_since`` token when it is recorded, so a
  late commit never clobbers a newer write.

The journal is strictly step-ordered: ``commit(n)`` finalizes the prefix
(deferred actions in record order), ``rollback(from_step)`` unwinds the
suffix (compensations in reverse record order), and ``patch(keep)`` is the
speculative loop's splice — keep the executed prefix that matches the
verified plan, unwind the divergent tail, and go on recording the
re-executed suffix in the same journal. Single-owner: one journal per
speculation, driven from one thread, so it takes no lock. The plain agent
loops use it too, committing each step as it ends.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class JournalStep:
    """One speculative step: eager undos + deferred commit actions."""

    index: int
    undos: List[Callable[[], None]] = field(default_factory=list)
    deferred: List[Callable[[], None]] = field(default_factory=list)
    label: str = ""

    def applied(self, undo: Callable[[], None]) -> None:
        """Record an eagerly-applied effect via its compensation closure."""
        self.undos.append(undo)

    def on_commit(self, action: Callable[[], None]) -> None:
        """Defer an effect (cache admission, metric bump) until commit."""
        self.deferred.append(action)


class StepJournal:
    """Ordered journal of reversible steps with prefix-commit semantics.

    State machine per step: *open* -> committed (prefix-only) or rolled
    back (suffix-only). ``open_steps()`` is the liveness surface: a
    speculation whose verify never resolved leaves its steps open.
    """

    def __init__(self) -> None:
        self._steps: List[JournalStep] = []
        self._committed = 0  # steps [0, _committed) are final
        self.steps_recorded = 0
        self.steps_committed = 0
        self.steps_rolled_back = 0

    # -- recording ----------------------------------------------------

    def begin_step(self, label: str = "") -> JournalStep:
        step = JournalStep(index=self._committed + len(self._open()), label=label)
        self._steps.append(step)
        self.steps_recorded += 1
        return step

    def _open(self) -> List[JournalStep]:
        return self._steps[self._committed:]

    def open_steps(self) -> int:
        """Steps recorded but neither committed nor rolled back."""
        return len(self._steps) - self._committed

    # -- resolution ---------------------------------------------------

    def commit(self, upto: int | None = None) -> int:
        """Commit the first ``upto`` open steps (all open steps when None).

        Deferred actions run in record order. Returns #steps committed.
        """
        pending = self.open_steps()
        n = pending if upto is None else min(upto, pending)
        if n < 0:
            raise ValueError("commit count must be >= 0")
        for step in self._steps[self._committed:self._committed + n]:
            for action in step.deferred:
                action()
        self._committed += n
        self.steps_committed += n
        return n

    def rollback(self, from_step: int = 0) -> int:
        """Unwind open steps from relative index ``from_step`` to the end.

        Compensations run in reverse record order (newest effect first),
        so nested workspace writes restore correctly. Returns #steps
        rolled back.
        """
        pending = self.open_steps()
        if from_step < 0 or from_step > pending:
            raise ValueError(f"rollback from_step {from_step} out of range "
                             f"(0..{pending})")
        doomed = self._steps[self._committed + from_step:]
        for step in reversed(doomed):
            for undo in reversed(step.undos):
                undo()
        del self._steps[self._committed + from_step:]
        self.steps_rolled_back += len(doomed)
        return len(doomed)

    def patch(self, keep: int) -> tuple:
        """Splice: commit the matching prefix of ``keep`` open steps, then
        roll back the divergent suffix. Returns (committed, rolled_back).
        The journal stays usable — the re-executed suffix records into it.
        """
        rolled = self.rollback(from_step=min(keep, self.open_steps()))
        committed = self.commit()
        return committed, rolled
