"""The share of the time in which no operation ran on the device, over
the traced waves: ``1 - busy / wall`` (``counts.idle_share``). Busy is the
union of the device events' intervals in a trace of device activity alone.
Wall is what the same waves take untraced (the window's mean wave of each
one's prompt length), not the traced waves' own wall: tracing slows the
host that dispatches the work (by 30% on a host-bound wave), not the
device's operations, so the traced wall would count the profiler's own
cost as idle. The run prints the stretch; ``device.window_s`` in the
result is the traced wall."""

from perfbench import counts

UNIT, LAYER, MOVES, SOURCE = "%", "device", "calls_per_s", "device_trace"


def read(r):
    if r.trace is None or r.untraced_s is None:
        return None
    return 100.0 * counts.idle_share(r.trace.busy_s, r.untraced_s)
