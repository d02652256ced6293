"""The whole step's share of the chip's bf16 peak: the operations the
window's calls need (the family's ``call_flops``: the head only where
``generate`` samples, the causal half of attention) over the window's own
wall time (the benchmark's clock, not the engine's timers) times
989 TFLOP/s."""

from perfbench import counts

UNIT, LAYER, MOVES, SOURCE = "%", "model step", "calls_per_s", "host_clock"


def read(r):
    c, new = r.traffic.concurrency, r.traffic.max_new
    flops = sum(c * r.family.call_flops(r.conf, s, new) for s, _ in r.waves)
    return 100.0 * flops / (r.window_s * counts.PEAK_BF16_FLOPS)
