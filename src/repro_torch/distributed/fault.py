"""Fault-tolerance manager: checkpoint / auto-resume training supervision
(the twin of ``repro.distributed.fault``, single process).

The runner wraps any step function: it checkpoints on a cadence, detects
failures (NaN/inf metrics, a stalled step, a lost worker) and rolls back to
the last committed step. Faults are injected through :class:`FaultSchedule`
(``inject(step, kind, **details)`` / ``pop(step)``). Step timing reads an
injectable ``clock`` (default: the monotonic perf counter), so straggler
tests drive a virtual clock instead of sleeping.

Metrics may be Python numbers, numpy values or tensors on any device: a
tensor is read with ``.item()`` (``np.asarray`` raises on a CUDA tensor,
which would hide a NaN loss on the card).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore


@dataclass
class FaultSpec:
    """One scheduled fault: what happens and (optionally) to whom."""

    kind: str  # "nan" | "stall" | "worker_lost" | simulation kinds ("crash", ...)
    details: Dict[str, Any] = field(default_factory=dict)


class FaultSchedule:
    """Step-indexed fault injection. Several faults may land on one step;
    ``pop`` returns them in injection order and removes them (a fault fires
    once)."""

    def __init__(self) -> None:
        self._by_step: Dict[int, List[FaultSpec]] = {}

    def inject(self, step: int, kind: str, **details: Any) -> None:
        self._by_step.setdefault(step, []).append(FaultSpec(kind, details))

    def pop(self, step: int) -> List[FaultSpec]:
        return self._by_step.pop(step, [])

    def pending(self) -> int:
        return sum(len(v) for v in self._by_step.values())

    def __bool__(self) -> bool:
        return bool(self._by_step)


@dataclass
class FaultPolicy:
    checkpoint_every: int = 50
    max_restarts: int = 5
    nan_tolerance: int = 0  # consecutive NaN steps tolerated before rollback
    step_deadline_factor: float = 5.0  # x median step time = straggler/stall
    min_steps_for_deadline: int = 10
    min_deadline_s: float = 0.5  # absolute floor (µs-scale jitter is not a stall)


@dataclass
class FaultEvent:
    step: int
    kind: str  # "nan" | "stall" | "worker_lost"
    action: str  # "rollback"


def _as_float(v: Any) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.item())
    return float(np.asarray(v))


class FaultTolerantRunner:
    def __init__(
        self,
        step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, Any]]],
        store: CheckpointStore,
        policy: FaultPolicy = FaultPolicy(),
        *,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.step_fn = step_fn
        self.store = store
        self.policy = policy
        # straggler detection compares readings of this clock
        self.clock = clock if clock is not None else time.perf_counter
        self.events: List[FaultEvent] = []
        self._step_times: List[float] = []
        self.schedule = FaultSchedule()

    def inject(self, step: int, kind: str, **details: Any) -> None:
        """Fail at a given step ('nan' | 'worker_lost' | 'stall')."""
        self.schedule.inject(step, kind, **details)

    def _is_bad(self, metrics: Dict[str, Any]) -> bool:
        for v in metrics.values():
            try:
                x = _as_float(v)
            except (TypeError, ValueError, RuntimeError):
                continue  # not a scalar metric
            if math.isnan(x) or math.isinf(x):
                return True
        return False

    def run(self, state: Any, batches: Callable[[int], Any], n_steps: int, *,
            start_step: int = 0) -> Tuple[Any, int, List[FaultEvent]]:
        """Runs with checkpoint/rollback; returns (state, completed, events)."""
        step = start_step
        restarts = 0
        last_ckpt = start_step
        # resume from the store if a later step is committed
        committed = self.store.committed_steps()
        if committed and committed[-1] > step:
            state, extra = self.store.restore(state)
            step = extra.get("step", committed[-1])
            last_ckpt = step
        while step < n_steps:
            # every fault scheduled for this step fires (pop is fire-once)
            injected = {spec.kind for spec in self.schedule.pop(step)}
            t0 = self.clock()
            try:
                if "worker_lost" in injected:
                    raise RuntimeError("injected worker loss")
                new_state, metrics = self.step_fn(state, batches(step))
                if "nan" in injected:
                    metrics = dict(metrics, loss=float("nan"))
                dt = self.clock() - t0
                if self._stalled(dt) or "stall" in injected:
                    raise TimeoutError(f"step {step} exceeded deadline ({dt:.2f}s)")
                if self._is_bad(metrics):
                    self.events.append(FaultEvent(step, "nan", "rollback"))
                    state, step, restarts = self._rollback(state, restarts)
                    continue
                self._step_times.append(dt)
                state = new_state
                step += 1
                if step % self.policy.checkpoint_every == 0:
                    self.store.save(step, state, extra={"step": step})
                    last_ckpt = step
            except (RuntimeError, TimeoutError) as e:
                kind = "stall" if isinstance(e, TimeoutError) else "worker_lost"
                self.events.append(FaultEvent(step, kind, "rollback"))
                state, step, restarts = self._rollback(state, restarts)
        if step != last_ckpt:  # the final checkpoint
            self.store.save(step, state, extra={"step": step})
        return state, step, self.events

    def _stalled(self, dt: float) -> bool:
        if len(self._step_times) < self.policy.min_steps_for_deadline:
            return False
        med = sorted(self._step_times)[len(self._step_times) // 2]
        deadline = max(med * self.policy.step_deadline_factor, self.policy.min_deadline_s)
        return dt > deadline

    def _rollback(self, state: Any, restarts: int) -> Tuple[Any, int, int]:
        restarts += 1
        if restarts > self.policy.max_restarts:
            raise RuntimeError("exceeded max_restarts; aborting run")
        committed = self.store.committed_steps()
        if not committed:
            return state, 0, restarts  # restart from scratch
        state, extra = self.store.restore(state)
        return state, extra.get("step", committed[-1]), restarts
