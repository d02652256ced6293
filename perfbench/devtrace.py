"""The device trace of a few waves, under ``torch.profiler``, reduced to
what the per-layer metrics read: the time some operation ran on the
device (the union of the device events' intervals), device seconds and
launches by kernel name, and the idle gaps between device operations,
each named by the innermost host operation running at its middle.

Recording every host operation slows the host, and so stretches the idle
gaps it causes. So the idle share and the kernels' times come from a
trace of device activity alone (``host=False``), and only the naming of
the gaps from a trace with the host's operations (``host=True``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

# how far back from a gap's middle to look for the host operation around it
_SCAN = 4000


@dataclass
class Trace:
    window_s: float  # host clock, from a synchronised start to a synchronised end
    busy_s: float  # union of the device operations' intervals
    cost_s: float = 0.0  # host seconds past the window: the profiler's stop and this reduction
    kernels: dict = field(default_factory=dict)  # name -> [seconds, launches]
    gaps: dict = field(default_factory=dict)  # host operation -> idle seconds

    def kernel_seconds(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds every one of
        ``parts``."""
        return sum(s for name, (s, _) in self.kernels.items() if all(p in name for p in parts))

    def kernel_launches(self, *parts: str) -> int:
        return sum(n for name, (_, n) in self.kernels.items() if all(p in name for p in parts))

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def profile(fn, *, host: bool) -> Trace:
    """Run ``fn()`` under the profiler, the device synchronised before and
    after, and reduce its trace. ``host``: record the host's operations
    too (for the gaps' names), at their cost in host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, on_host = [], []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        (dev if e.device_type() == DeviceType.CUDA else on_host).append(
            (e.start_ns(), e.start_ns() + dur, e.name()))
    trace = reduce(window, dev, on_host)
    trace.cost_s = time.perf_counter() - t0 - window
    return trace


def reduce(window_s: float, dev, host) -> Trace:
    """``dev`` and ``host``: (start ns, end ns, name) of the device and host
    events."""
    kernels = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        kernels[name][0] += (b - a) * 1e-9
        kernels[name][1] += 1
    spans = _merge(sorted((a, b) for a, b, _ in dev))
    busy = sum(b - a for a, b in spans) * 1e-9
    host = sorted(host)
    starts = [a for a, _, _ in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        gaps[_around(host, starts, (end + nxt) // 2)] += (nxt - end) * 1e-9
    return Trace(window_s=window_s, busy_s=busy, kernels=dict(kernels), gaps=dict(gaps))


def _merge(iv):
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _around(host, starts, t) -> str:
    """The innermost host event that contains time ``t``: on one thread
    nested events contain each other, so the latest start that still
    covers ``t`` is the innermost."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - _SCAN, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host python (no operation)"
