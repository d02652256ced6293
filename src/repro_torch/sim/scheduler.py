"""Seeded step scheduler: deterministic interleaving of concurrent clients
(the twin of ``repro.sim.scheduler``).

FoundationDB-style simulation reduces concurrency to a *seeded choice of
interleaving*: each logical client is a queue of operations; at every step
the scheduler (a) applies deferred actions that came due (lagged replica
writes), (b) fires faults scheduled for this step, then (c) picks ONE
runnable client with the seeded RNG and executes its next operation
atomically. Operations are atomic because the stores under test serialize
them under their documented locks — the scheduler explores the space of
*orderings between* lock-grained operations, which is exactly where
distributed-cache races live (admission vs. eviction, crash vs. lookup,
lag vs. fallthrough).

The step counter is the virtual-time axis: fault plans and deferred writes
are indexed by step, and the virtual clock advances a fixed tick per step
(plus whatever per-call latency the fault interceptor charges).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.distributed.fault import FaultSchedule, FaultSpec
from repro_torch.sim.clock import VirtualClock


class StepScheduler:
    """Drives clients/faults/deferred-actions in one deterministic order."""

    def __init__(
        self,
        seed: int,
        clock: VirtualClock,
        *,
        tick_s: float = 1e-3,
    ):
        self.rng = random.Random(("sim-sched", seed).__repr__())
        self.clock = clock
        self.tick_s = tick_s
        self.step = 0
        self._clients: List[Tuple[str, List[Dict[str, Any]]]] = []
        self._queues: Dict[str, List[Dict[str, Any]]] = {}
        self._cursor: Dict[str, int] = {}
        self._deferred: List[Tuple[int, int, Callable[[], None]]] = []
        self._seq = 0  # tie-break so same-step deferred actions keep order

    def add_client(self, name: str, ops: List[Dict[str, Any]]) -> None:
        self._clients.append((name, ops))
        self._queues[name] = ops
        self._cursor[name] = 0

    def extend_client(self, name: str, ops: List[Dict[str, Any]]) -> None:
        """Append ops to an existing client's queue mid-run.

        This is how dynamically-spawned work enters the interleaving: the
        sim's async cache-generation pool registers idle worker clients up
        front and feeds them tasks as the router submits waves, so a
        worker's op competes for scheduling like any client op (the seeded
        RNG owns the admission race). A client with new ops becomes
        runnable again on the next step — quiescence is only declared when
        every queue (static and dynamically extended) is drained."""
        if name not in self._queues:
            raise KeyError(f"unknown scheduler client {name!r}")
        self._queues[name].extend(ops)

    def defer(self, delay_steps: int, fn: Callable[[], None]) -> None:
        """Schedule fn to run at the START of step ``now + delay_steps``
        (lagged replica writes, delayed restarts)."""
        self._seq += 1
        self._deferred.append((self.step + max(1, delay_steps), self._seq, fn))

    def _runnable(self) -> List[Tuple[str, List[Dict[str, Any]]]]:
        return [(n, ops) for n, ops in self._clients if self._cursor[n] < len(ops)]

    def run(
        self,
        on_op: Callable[[int, str, Dict[str, Any]], None],
        *,
        faults: Optional[FaultSchedule] = None,
        on_fault: Optional[Callable[[int, FaultSpec], None]] = None,
        max_steps: int = 100_000,
    ) -> int:
        """Run to quiescence: all client ops applied, deferred queue empty,
        fault schedule drained. Returns the number of steps executed."""
        while self.step < max_steps:
            # (a) deferred actions due now, in (due, seq) order
            due = sorted(
                [d for d in self._deferred if d[0] <= self.step],
                key=lambda d: (d[0], d[1]),
            )
            if due:
                self._deferred = [d for d in self._deferred if d[0] > self.step]
                for _, _, fn in due:
                    fn()
            # (b) faults scheduled for this step
            if faults is not None:
                for spec in faults.pop(self.step):
                    if on_fault is not None:
                        on_fault(self.step, spec)
            # (c) one seeded client op; idle steps still tick virtual time
            # (the run stays live until a future fault/deferred action lands)
            runnable = self._runnable()
            if runnable:
                name, ops = runnable[self.rng.randrange(len(runnable))]
                op = ops[self._cursor[name]]
                self._cursor[name] += 1
                on_op(self.step, name, op)
            elif not self._deferred and not (faults and faults.pending()):
                break  # quiescent
            self.clock.advance(self.tick_s)
            self.step += 1
        return self.step


__all__ = ["StepScheduler"]
