"""The engine's phases on the device trace (``phases.py``): the reduction on
made-up events and spans, its run at a tiny size on the CPU, and, on the
card, the shared clock it rests on: a span on ``profiler_clock`` holds the
kernel it waited for in the same profiler trace."""

import pytest
import torch

from perfbench import devtrace, harness, phases, tiny

DEV = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3"), (300, 310, "k1")]
HOST = [(0, 200, "outer"), (21, 29, "aten::mm"), (45, 95, "aten::item"),
        (50, 60, "cudaMemcpyAsync")]


def _span(name, a, b):
    return {"name": name, "start": a * 1e-9, "end": b * 1e-9}


SPANS = [_span("engine.generate", 0, 200), _span("engine.prefill", 0, 22),
         _span("engine.decode_step", 28, 80), _span("engine.decode_step", 95, 120)]


def test_reduce_clips_busy_time_and_counts_operations_inside_spans():
    t = phases.reduce(1e-6, DEV, HOST, SPANS)
    base = devtrace.reduce(1e-6, DEV, HOST)
    assert (t.busy_s, t.kernels) == (base.busy_s, base.kernels)  # the device's own numbers
    assert t.span_count == {"engine.decode_step": 2, "engine.generate": 1, "engine.prefill": 1}
    # device busy [0, 20], [30, 40], [100, 110], [300, 310]
    assert t.span_busy_s == {"engine.decode_step": pytest.approx(20e-9),
                             "engine.generate": pytest.approx(40e-9),
                             "engine.prefill": pytest.approx(20e-9)}
    assert t.span_ops == {"engine.decode_step": 2, "engine.generate": 4, "engine.prefill": 2}
    assert t.per_span("engine.decode_step") == (pytest.approx(1e-5), 1.0)
    assert t.per_span("router.route") is None


def test_reduce_names_each_gap_by_span_and_host_operation():
    t = phases.reduce(1e-6, DEV, HOST, SPANS)
    # gap 20..30 (middle 25: past the prefill, in generate and aten::mm),
    # 40..100 (70: a decode step, aten::item), 110..300 (205: no span, no op)
    assert t.gaps == {"engine.generate / aten::mm": pytest.approx(10e-9),
                      "engine.decode_step / aten::item": pytest.approx(60e-9),
                      "outside engine / host python (no operation)": pytest.approx(190e-9)}
    assert t.gap_share() == {"outside engine": pytest.approx(190 / 260),
                             "engine.decode_step": pytest.approx(60 / 260),
                             "engine.generate": pytest.approx(10 / 260)}
    assert t.breakdown()["idle_gaps"][0][0] == "outside engine / host python (no operation)"


def test_reduce_without_spans_is_the_device_traces_own():
    t = phases.reduce(1e-6, DEV, HOST, ())
    base = devtrace.reduce(1e-6, DEV, HOST)
    assert (t.busy_s, t.kernels, t.gaps) == (base.busy_s, base.kernels, base.gaps)
    assert t.span_count == {} and t.per_span("engine.decode_step") is None


def test_measure_runs_at_a_tiny_size_on_the_cpu(monkeypatch):
    """The script's steps on the CPU: the window's host part of a decode
    step within its whole, four traced runs, and nothing read of a device
    that was not traced."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    cell, cfg = tiny.cell(harness.cell_names()[1])
    out = phases.measure(cell, 2**31 + 3, 8, "cpu", cfg=cfg)
    w = out["window"]
    assert w["decode_steps"] == 8 * (cell.traffic["max_new"] - 1)
    assert 0 < w["decode_host_ms_per_step"] <= w["decode_ms_per_step"]
    assert [r["tracer"] for r in out["traced"]] == [False, True, True, False]
    assert all(r["waves"] == 1 and r["stretch"] > 0 and r["busy_s"] == 0 for r in out["traced"])
    assert not any("decode_device_ms" in r for r in out["traced"])
    assert out["with_host"]["idle_s"] == 0 and out["device"]["platform"] == "cpu"


@pytest.mark.card
@pytest.mark.parametrize("host", [False, True], ids=["device_only", "with_host"])
def test_a_span_on_the_profiler_clock_holds_its_kernel(card, host):
    """A bf16 matmul, waited for inside a span on ``profiler_clock``: the
    kernel's interval in the same profiler trace lies inside the span, to
    within 50 us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import InMemoryExporter, Tracer, profiler_clock, trace_span, use_tracer

    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    (a @ a).sum().item()  # warm: the library's handle and kernel
    mem = InMemoryExporter()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        with use_tracer(Tracer(clock=profiler_clock, exporters=[mem])):
            with trace_span("engine.decode_step", step=0, active=1):
                a @ a
                torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    assert kernels
    (sp,) = mem.spans
    lo, hi = sp["start"] * 1e9, sp["end"] * 1e9
    for k in kernels:
        assert lo - 50e3 <= k.start_ns() and k.start_ns() + k.duration_ns() <= hi + 50e3, (
            k.name(), k.start_ns() - lo, hi - k.start_ns() - k.duration_ns())
