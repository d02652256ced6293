"""Continuous-batching scheduler with straggler hedging (the twin of
``repro.serving.scheduler``).

Requests arrive asynchronously; the scheduler packs them into fixed-size
decode slots (continuous batching: a finished request's slot is re-assigned
at once) and hedges stragglers: a request running longer than
``hedge_after_s`` is moved to another replica, and the first replica's work
is counted as wasted.

The scheduler is engine-agnostic and, as in the reference, no caller wires
it to an engine: it steps its slots against an injectable clock, so tests
drive it with a simulated one.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass(order=True)
class Request:
    arrival: float
    id: str = field(compare=False)
    prompt_tokens: int = field(compare=False, default=0)
    max_new: int = field(compare=False, default=32)
    tier: str = field(compare=False, default="actor")
    # runtime state
    generated: int = field(compare=False, default=0)
    started: Optional[float] = field(compare=False, default=None)
    finished: Optional[float] = field(compare=False, default=None)
    hedged: bool = field(compare=False, default=False)
    replica: int = field(compare=False, default=0)


@dataclass
class SchedulerConfig:
    max_batch: int = 8
    hedge_after_s: float = 5.0  # straggler deadline
    n_replicas: int = 2
    step_time_fn: Optional[Callable[[int], float]] = None  # batch -> seconds/step


class ContinuousBatcher:
    """Slot-based continuous batching over one engine tier."""

    def __init__(self, cfg: SchedulerConfig, clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.clock = clock or time.monotonic
        self.queue: List[Request] = []
        self.active: List[Request] = []
        self.done: List[Request] = []
        self.hedges = 0
        self.wasted_steps = 0

    def submit(self, req: Request) -> None:
        heapq.heappush(self.queue, req)

    def _fill_slots(self) -> None:
        while self.queue and len(self.active) < self.cfg.max_batch:
            r = heapq.heappop(self.queue)
            r.started = self.clock()
            self.active.append(r)

    def step(self) -> int:
        """One decode step across active slots; returns #completed."""
        self._fill_slots()
        if not self.active:
            return 0
        now = self.clock()
        # hedging: re-dispatch stragglers to another replica
        for r in self.active:
            if (
                not r.hedged
                and self.cfg.n_replicas > 1
                and r.started is not None
                and now - r.started > self.cfg.hedge_after_s
            ):
                r.hedged = True
                r.replica = (r.replica + 1) % self.cfg.n_replicas
                self.hedges += 1
                self.wasted_steps += r.generated  # first replica's work dropped
                r.generated = max(0, r.generated - 1)  # restart near the end
        completed = 0
        still: List[Request] = []
        for r in self.active:
            r.generated += 1
            if r.generated >= r.max_new:
                r.finished = self.clock()
                self.done.append(r)
                completed += 1
            else:
                still.append(r)
        self.active = still
        return completed

    def run_until_idle(self, max_steps: int = 100_000) -> Dict[str, float]:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step()
            steps += 1
        lat = [
            (r.finished - r.arrival)
            for r in self.done
            if r.finished is not None and r.arrival is not None
        ]
        lat.sort()
        return {
            "completed": len(self.done),
            "steps": steps,
            "hedges": self.hedges,
            "wasted_steps": self.wasted_steps,
            "p50_s": lat[len(lat) // 2] if lat else 0.0,
            "p99_s": lat[int(len(lat) * 0.99)] if lat else 0.0,
        }
