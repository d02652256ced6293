"""Calls completed in the window over the window's seconds (host clock)."""

UNIT, BETTER, SOURCE = "calls/s", "higher", "host_clock"


def read(r):
    return r.calls / r.window_s
