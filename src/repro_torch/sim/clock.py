"""Virtual time for the deterministic simulation (the twin of
``repro.sim.clock``).

Every time-dependent seam of the serving and distributed layers
(``PlanCache`` TTL expiry, the router's lookup latency) takes a ``clock``
callable. In production that is ``time.time`` / ``time.perf_counter``;
under simulation it is a :class:`VirtualClock`, advanced only by the step
scheduler, the fault interceptor's per-call latency and the cachegen pool's
submit latency. So a run's behaviour, and its trace hash, is a function of
``(seed, config)`` alone. Wall-latency metrics that feed no decision
(``CacheStats.lookup_time_s``) still read the perf counter and stay out of
the trace.
"""

from __future__ import annotations


class VirtualClock:
    """Monotonic virtual seconds; advanced explicitly, never by the OS."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual time cannot go backwards (dt={dt})")
        self.t += dt
        return self.t

    def __repr__(self) -> str:
        return f"VirtualClock(t={self.t:.6f})"


__all__ = ["VirtualClock"]
