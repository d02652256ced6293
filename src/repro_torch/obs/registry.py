"""The metrics registry: counters, gauges and bucketed histograms (the twin
of ``repro.obs.registry``).

One :class:`MetricsRegistry` is the accounting spine of a serving path: the
router, the plan stores, the match stages and the index backends register
their counters here. ``RouterMetrics``, ``CacheStats``, ``LSHTelemetry`` and
``DeviceBank``'s upload counters are views over it (with the reference's
field reads and ``snapshot()`` schemas), so one ``registry.snapshot()``
covers every layer.

* **Label-keyed.** A series is ``(name, labels)``: ``shard="cache-0"`` and
  ``shard="cache-1"`` are two series of one name.
  ``registry.counter(name, **labels)`` returns the one instance of that
  series; callers keep the handle.
* **Lock-safe.** Every mutation takes the metric's own lock, so cache
  generation workers and request threads may bump one counter. ``inc`` is
  the contract for unlocked callers; ``set`` (behind the ``+=`` property
  shims of the views) is safe only under the owning store's lock.
* **Deterministic snapshots.** ``snapshot()`` sorts names and label sets,
  so ``json.dumps(snapshot(), sort_keys=True)`` is byte-stable.
* **Catalogued names** live in :mod:`repro_torch.obs.names`.

Histogram percentiles interpolate linearly inside the winning bucket (the
Prometheus rule), clamped to the observed min and max. Bucket bounds are
the reference's: ``latency_buckets()`` (1 us doubling up to 120 s) by
default, ``pow2_buckets(32)`` for counts.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic (by convention) float/int accumulator. ``inc`` is
    lock-safe; ``set`` serves the ``+=`` property shims of the views,
    which are only safe under the owning store's lock."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value: float = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def reset(self) -> None:
        self.set(0)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(Counter):
    """A value that goes up and down (arena capacity, pool depth)."""

    __slots__ = ()

    def dec(self, n: float = 1) -> None:
        self.inc(-n)


def latency_buckets(lo: float = 1e-6, hi: float = 120.0) -> Tuple[float, ...]:
    """Geometric (x2) bucket bounds for second-scale latencies."""
    out: List[float] = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2.0
    out.append(hi)
    return tuple(out)


def pow2_buckets(n: int = 32) -> Tuple[float, ...]:
    """Bounds 1, 2, 4, ... — bucket i counts values in [2^(i-1), 2^i)."""
    return tuple(float(1 << i) for i in range(n))


DEFAULT_LATENCY_BUCKETS = latency_buckets()


class Histogram:
    """Bucketed histogram with p50/p90/p99 by in-bucket interpolation.

    ``bounds`` are ascending upper bounds; an implicit +inf bucket catches
    overflow. Also tracks count/sum/min/max so means and tails survive the
    bucketing.
    """

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None,
                 labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        bs = tuple(bounds) if bounds is not None else DEFAULT_LATENCY_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram bounds must be ascending: {bs}")
        self.bounds = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)  # v <= bounds[i]
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]. None when empty. Linear interpolation inside the
        winning bucket, clamped to observed min/max."""
        with self._lock:
            if self._count == 0:
                return None
            target = (q / 100.0) * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if cum + c >= target:
                    frac = (target - cum) / c
                    return lo + (hi - lo) * min(1.0, max(0.0, frac))
                cum += c
            return self._max

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
            counts = list(self._counts)
            mn = self._min if count else None
            mx = self._max if count else None
        out: Dict[str, Any] = {
            "count": count,
            "sum": round(total, 9),
            "min": mn,
            "max": mx,
            "mean": round(total / count, 9) if count else None,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }
        out["buckets"] = {
            (f"le_{self.bounds[i]:g}" if i < len(self.bounds) else "le_inf"): c
            for i, c in enumerate(counts) if c
        }
        return out


class MetricsRegistry:
    """Name+labels -> metric instance; one per serving spine.

    A metric name has ONE kind (counter | gauge | histogram) — asking for
    the same name with a different kind is a programming error and raises.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, Any],
             factory) -> Any:
        key = (name, _label_key(labels))
        with self._lock:
            known = self._kinds.get(name)
            if known is not None and known != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {known}, "
                    f"requested as {kind}"
                )
            inst = self._metrics.get(key)
            if inst is None:
                inst = factory(name, key[1])
                self._metrics[key] = inst
                self._kinds[name] = kind
            return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  **labels: Any) -> Histogram:
        return self._get(
            "histogram", name, labels,
            lambda n, lk: Histogram(n, bounds, lk),
        )

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._kinds)

    def reset(self) -> None:
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def snapshot(self) -> Dict[str, Any]:
        """{name: {label_str: value | histogram dict}}, fully sorted —
        ``json.dumps(snapshot(), sort_keys=True)`` is byte-stable."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for (name, lk), m in items:
            series = out.setdefault(name, {})
            val = m.snapshot() if isinstance(m, Histogram) else m.value
            series[_label_str(lk)] = val
        return out


__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "latency_buckets",
    "pow2_buckets",
]
