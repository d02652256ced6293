"""The engine's phases on the device trace: how much device time, how many
device operations and which idle gaps fall inside the spans that
``Engine.generate`` opens (``engine.prefill`` and one ``engine.decode_step``
a step, under ``engine.generate``), with the spans stamped on
``torch.profiler``'s clock (``repro_torch.obs.profiler_clock``).

    python3 -m perfbench.phases --workload <cell> --seed <n>

Run from the root of a checkout, on the card. It serves the cell's traffic
as ``run.py`` does (the same weights, prompts and engine, one warm wave at
the longest prompt), then:

* ``WINDOW_WAVES`` untraced waves: the engine's decode time a step
  (``EngineStats.decode_s``) and the host's part of it, from the step's
  start until its work is enqueued (``EngineStats.decode_host_s``);
* the traced waves of ``run.py --trace 1`` (device activity alone, at least
  ``harness.TRACE_WAVES`` waves and ``harness.TRACE_SECONDS`` seconds) four
  times, without, with, with and without a tracer: each run's stretch
  against the untraced waves of its prompt lengths (the spans' own cost is
  the difference), and, with the tracer, the device's busy time and its
  operations inside the spans, a span, and the idle time's share by span;
* one wave traced with the host's operations and the spans: every idle gap
  named ``<innermost engine span> / <innermost host operation>``, and the
  idle time's share by span.

Prints one JSON line. The benchmark's runs (``harness.serve``) install no
tracer, so no metric of ``BENCHMARK.json`` reads the spans yet: :func:`reduce`
is the reduction a traced run would call on them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench import devtrace, harness

ROOT = pathlib.Path(__file__).resolve().parents[1]

DECODE, PREFILL = "engine.decode_step", "engine.prefill"
OUTSIDE = "outside engine"  # a gap's name where no span covers it
WINDOW_WAVES = 16  # every prompt length twice: the traced waves' untraced base


@dataclass
class PhaseTrace(devtrace.Trace):
    """``devtrace.Trace`` with its gaps named by span as well, and per span
    name: the device's busy seconds inside those spans (the union of the
    device intervals clipped to them), their count, and the device
    operations (kernels and copies) that start inside them."""

    span_busy_s: dict = field(default_factory=dict)
    span_count: dict = field(default_factory=dict)
    span_ops: dict = field(default_factory=dict)

    def per_span(self, name: str):
        """(device ms, device operations) a span of ``name``; None where the
        trace holds no such span or no device work inside one."""
        n = self.span_count.get(name, 0)
        if not n or not self.span_ops[name]:
            return None
        return 1e3 * self.span_busy_s[name] / n, self.span_ops[name] / n

    def gap_share(self) -> dict:
        """The idle time's share by span name (the part of a gap's name
        before `` / ``)."""
        total = sum(self.gaps.values())
        out = {}
        for name, s in self.gaps.items():
            span = name.split(" / ", 1)[0]
            out[span] = out.get(span, 0.0) + (s / total if total else 0.0)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _ns(seconds: float) -> int:
    return round(seconds * 1e9)


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(window_s: float, dev, host, spans) -> PhaseTrace:
    """``dev`` and ``host`` as ``devtrace.reduce`` takes them; ``spans``:
    finished spans (``InMemoryExporter.spans``) on the profiler's clock.
    The busy time and the kernels are ``devtrace.reduce``'s; each idle gap
    is named ``<innermost span> / <innermost host operation>`` at its
    middle, ``outside engine / ...`` where no span covers it. With no
    spans the result is ``devtrace.reduce``'s."""
    if not spans:
        return PhaseTrace(**vars(devtrace.reduce(window_s, dev, host)))
    # its busy time and kernels; with no host events its gaps cost a bisect each
    base = devtrace.reduce(window_s, dev, ())
    iv = sorted((_ns(s["start"]), _ns(s["end"]), s["name"]) for s in spans)
    busy = devtrace._merge(sorted((a, b) for a, b, _ in dev))
    op_starts = sorted(a for a, _, _ in dev)
    span_busy, count, ops = {}, {}, {}
    for name in sorted({n for _, _, n in iv}):
        mine = [(a, b) for a, b, n in iv if n == name]
        count[name] = len(mine)
        mine = devtrace._merge(mine)
        span_busy[name] = _overlap(busy, mine) * 1e-9
        ops[name] = sum(bisect.bisect_left(op_starts, b) - bisect.bisect_left(op_starts, a)
                        for a, b in mine)
    host = sorted(host)
    host_starts = [a for a, _, _ in host]
    span_starts = [a for a, _, _ in iv]
    gaps = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) // 2
        span = devtrace._around(iv, span_starts, mid)
        op = devtrace._around(host, host_starts, mid)
        name = f"{span if span in count else OUTSIDE} / {op}"
        gaps[name] = gaps.get(name, 0.0) + (nxt - end) * 1e-9
    return PhaseTrace(window_s=base.window_s, busy_s=base.busy_s, kernels=base.kernels,
                      gaps=gaps, span_busy_s=span_busy, span_count=count, span_ops=ops)


def profile(fn, device, *, host: bool, spans: bool) -> PhaseTrace:
    """``devtrace.profile`` with, where ``spans``, a tracer on the
    profiler's clock installed around ``fn()``, its spans handed to
    :func:`reduce`. On the CPU only the host is traced: no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    from repro_torch.obs import InMemoryExporter, Tracer, profiler_clock, use_tracer

    cuda = torch.device(device).type == "cuda"
    activities = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    mem = InMemoryExporter()
    harness._sync(device)
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if spans:
            with use_tracer(Tracer(clock=profiler_clock, exporters=[mem])):
                fn()
        else:
            fn()
        harness._sync(device)
        window = time.perf_counter() - t0
    dev, on_host = [], []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur > 0:
            (dev if e.device_type() == DeviceType.CUDA else on_host).append(
                (e.start_ns(), e.start_ns() + dur, e.name()))
    trace = reduce(window, dev, on_host, mem.spans)
    trace.cost_s = time.perf_counter() - t0 - window
    return trace


def measure(cell: harness.Cell, seed: int, waves: int, device, cfg=None) -> dict:
    """One run of the steps in the module's docstring; returns the JSON
    line's fields. ``cfg`` as ``harness.serve`` takes it."""
    from perfbench import weights
    from perfbench.traffic import Traffic
    from repro_torch.serving.engine import Engine

    conf = cell.conf
    params = weights.make(conf, seed, device)
    traffic = Traffic(cell.traffic, conf["vocab_size"], seed)
    engine = Engine(cfg or harness.model_config(conf), params, max_len=traffic.max_len,
                    device=device)
    max_new = traffic.max_new
    engine.generate(traffic.warm_prompts(traffic.lengths[-1]), max_new=max_new)
    served = []  # (prompt length, seconds) of every wave after the warm one

    def wave():
        p = traffic.prompts(len(served))
        t = time.perf_counter()
        engine.generate(p, max_new=max_new)
        harness._sync(device)
        served.append((p.shape[1], time.perf_counter() - t))

    st = engine.stats
    s0 = (st.decode_s, st.decode_host_s, st.decode_tokens)
    for _ in range(waves):
        wave()
    window = served[:]
    steps = (st.decode_tokens - s0[2]) // traffic.concurrency
    out = {"cell": cell.name, "seed": seed,
           "device": harness.device_info(device, cell.chips, 0, None),
           "window": {"waves": waves, "decode_steps": steps,
                      "decode_ms_per_step": 1e3 * (st.decode_s - s0[0]) / steps,
                      "decode_host_ms_per_step": 1e3 * (st.decode_host_s - s0[1]) / steps},
           "traced": []}

    def traced():
        t, n = time.perf_counter(), len(served)
        while (len(served) - n < harness.TRACE_WAVES
               or time.perf_counter() - t < harness.TRACE_SECONDS):
            wave()

    for spans in (False, True, True, False):
        n = len(served)
        tr = profile(traced, device, host=False, spans=spans)
        run = {"tracer": spans, "waves": len(served) - n,
               "stretch": harness.trace_stretch(window, served[n:]), "busy_s": tr.busy_s}
        for name, key in ((DECODE, "decode"), (PREFILL, "prefill")):
            got = tr.per_span(name)
            if got is not None:
                run[f"{key}_device_ms"], run[f"{key}_ops"] = got
                run[f"{key}_spans"] = tr.span_count[name]
        if spans:
            run["idle_by_span"] = tr.gap_share()
        out["traced"].append(run)
    n = len(served)
    tr = profile(wave, device, host=True, spans=True)
    out["with_host"] = {"stretch": harness.trace_stretch(window, served[n:]),
                        "idle_s": sum(tr.gaps.values()), "idle_by_span": tr.gap_share(),
                        "idle_gaps": tr.breakdown(len(tr.gaps))["idle_gaps"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    cell = harness.load_cell(args.workload)
    why = harness.card_check(cell.chips)
    if why:
        print(f"perfbench: {why}", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, args.seed, WINDOW_WAVES, "cuda:0")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
