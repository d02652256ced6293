"""The 95th percentile (nearest rank), over every call completed in the
window, of the time from its wave's submission to its tokens on the host.
All calls of a wave share that time, so the independent samples are the
waves; the run prints their count."""

from perfbench.harness import percentile

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(r):
    return percentile(r.call_latencies(), 95)
