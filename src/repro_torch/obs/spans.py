"""Structured spans: the tracing half of ``repro_torch.obs`` (the twin of
``repro.obs.spans``).

A :class:`Span` is one timed operation with attributes and point-in-time
events. Spans nest through a context-local current span (a
``contextvars.ContextVar``), so the router, the distributed cache, the
match stages, the index and the engines compose one tree per request
without passing a span handle around:

    with trace_span("router.route_batch", batch=len(reqs)) as sp:
        ...                       # children attach to sp
        sp.event("cache.attribution", i=0, hit=True, tokens_saved=412)

* ``trace_span(name, **attrs)`` — a context manager that sets and restores
  the current span.
* ``tracer.start_span(name, parent=..., **attrs)`` and ``span.end()`` — the
  explicit API for work on pool threads, whose context starts empty: the
  router captures the parent at submit time.

Span ids are sequential per tracer (allocated under a lock) and timestamps
come from the tracer's injectable ``clock``, so a run on a virtual clock
exports the same bytes every time. A span measures host time: a span around
device work reads the device's time only if the work has been waited for
inside it (``Engine.generate`` returns host arrays, so its span does).

With no tracer installed ``trace_span`` returns a shared no-op span: no
allocation, no clock read, no lock.

A tracer's default clock is ``time.perf_counter``, which ``torch.profiler``
does not use: a tracer built with ``clock=profiler_clock`` stamps its spans
on the profiler's timebase, so they can be laid over a device trace.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, List, Optional


def profiler_clock() -> float:
    """Seconds on the timebase ``torch.profiler`` stamps host events with
    (and, through CUPTI, the device's): on Linux the unix clock, so
    ``time.time_ns() * 1e-9``. A float64 of ~1.8e9 seconds resolves about
    0.24 us at today's epoch, ample for spans of tens of microseconds and
    up. Multiply by 1e9 to compare with a kineto event's ``start_ns()``."""
    return time.time_ns() * 1e-9


class Span:
    """One timed operation. Created by a :class:`Tracer`; ended exactly
    once (idempotent ``end``)."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end_time",
                 "attrs", "events", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: Optional[int], start: float,
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_time: Optional[float] = None
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []
        self._tracer = tracer
        self._token = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """A point-in-time event on this span (e.g. one request's
        cache-attribution record)."""
        self.events.append(
            {"name": name, "t": self._tracer.clock(), "attrs": attrs}
        )

    def end(self) -> None:
        if self.end_time is None:
            self.end_time = self._tracer.clock()
            self._tracer._finish(self)

    # -- context-manager protocol (sets/restores the current span) --------

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end_time,
            "attrs": self.attrs,
            "events": self.events,
        }


class _NoopSpan:
    """Shared do-nothing span: the cost of disabled tracing."""

    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = None
    attrs: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOOP_SPAN = _NoopSpan()

# context-local current span: per-thread, per-context; pool threads start
# empty (async paths pass parents explicitly via start_span)
_current_span: ContextVar[Optional[Span]] = ContextVar(
    "repro_torch_obs_current_span", default=None
)


class Tracer:
    """Span factory + exporter fan-out with an injectable clock.

    ``clock`` is any ``() -> float``; production uses the monotonic perf
    counter; a test passes a virtual clock so span
    streams are deterministic per seed.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 exporters: Optional[List[Any]] = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.exporters: List[Any] = list(exporters or [])
        self._lock = threading.Lock()
        self._next_id = 1
        self.n_spans = 0

    def _alloc_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def span(self, name: str, **attrs: Any) -> Span:
        """A span parented on the context-local current span. Use as a
        context manager (``with tracer.span(...)``)."""
        parent = _current_span.get()
        return Span(self, name, self._alloc_id(),
                    None if parent is None else parent.span_id,
                    self.clock(), attrs)

    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   **attrs: Any) -> Span:
        """Explicit-parent span for async paths; caller must ``end()`` it
        (it does NOT install itself as the current span)."""
        pid = None
        if parent is not None and not isinstance(parent, _NoopSpan):
            pid = parent.span_id
        return Span(self, name, self._alloc_id(), pid, self.clock(), attrs)

    def _finish(self, span: Span) -> None:
        with self._lock:
            self.n_spans += 1
            for e in self.exporters:
                e.export(span)

    def close(self) -> None:
        for e in self.exporters:
            close = getattr(e, "close", None)
            if close is not None:
                close()


class NoopTracer:
    """Installed by default: every span is the shared no-op span."""

    clock = staticmethod(time.perf_counter)
    n_spans = 0

    def span(self, name: str, **attrs: Any) -> _NoopSpan:
        return NOOP_SPAN

    def start_span(self, name: str, *, parent: Optional[Any] = None,
                   **attrs: Any) -> _NoopSpan:
        return NOOP_SPAN

    def close(self) -> None:
        pass


NOOP_TRACER = NoopTracer()

# process-global active tracer. A module global (not a contextvar) on
# purpose: worker threads spawned by the router/tier pools must see the
# tracer installed by the main thread. Installation is scoped via
# use_tracer(); concurrent *different* tracers in one process are not a
# supported configuration (tests serialize through use_tracer).
_active: Any = NOOP_TRACER
_active_lock = threading.Lock()


def get_tracer() -> Any:
    return _active


def set_tracer(tracer: Optional[Any]) -> Any:
    """Install (or, with None, uninstall) the process-global tracer;
    returns the previous one."""
    global _active
    with _active_lock:
        prev = _active
        _active = tracer if tracer is not None else NOOP_TRACER
        return prev


@contextmanager
def use_tracer(tracer: Any):
    """Scoped install: ``with use_tracer(Tracer(...)) as tr: ...``"""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def trace_span(name: str, **attrs: Any):
    """The instrumentation entry point: a context-managed span on the
    active tracer (no-op when tracing is disabled)."""
    return _active.span(name, **attrs)


def current_span() -> Any:
    """The context-local current span (NOOP_SPAN when none) — use it to
    attach events from instrumented library code."""
    sp = _current_span.get()
    return NOOP_SPAN if sp is None else sp


__all__ = [
    "NOOP_SPAN",
    "NOOP_TRACER",
    "NoopTracer",
    "Span",
    "Tracer",
    "current_span",
    "get_tracer",
    "profiler_clock",
    "set_tracer",
    "trace_span",
    "use_tracer",
]
