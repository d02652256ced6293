"""Set-up: from the start of ``run.py`` through the warm-up wave (one, at
the longest prompt): torch's start, the kernels loaded (built on a
checkout's first run), the weights made from the seed, the engine built."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(r):
    return r.setup_s
