"""The flash-attention kernel's share of its roofline over the traced
waves: the least time their prefill launches (one a layer with attention,
by the family's ``attention_shapes``) could take (operations at 989 TFLOP/s or
bytes at 3.35 TB/s, whichever is longer, from ``counts.flash_launch``)
over the kernel's device time in the trace."""

from perfbench import counts

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "calls_per_s", "device_trace"
KERNEL = ("flash_",)


def read(r):
    a = r.family.attention_shapes(r.conf)
    if r.trace is None or a is None:
        return None
    t = r.trace.kernel_seconds(*KERNEL)
    n = r.trace.kernel_launches(*KERNEL)
    if t <= 0 or n != len(r.traced_waves) * a.layers:
        return None  # not the path this reader counts
    c = r.traffic.concurrency
    bound = sum(counts.roofline_seconds(*counts.flash_launch(a, c, s)) * a.layers
                for s in r.traced_waves)
    return 100.0 * bound / t
