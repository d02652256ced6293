"""The Mamba-2 scan kernel's share of its roofline over the traced waves:
the least time their prefill launches (one a Mamba-2 layer, by the family's
``mamba_layers``) could take, from the family's ``ssd_launch`` (the scan's
least operations, 4·P·N a head and step, at 989 TFLOP/s, or its bytes, x,
dt, B and C read and y (in the served dtype) and the final state written
once, at 3.35 TB/s,
whichever is longer), over the ``ssd_kernel``'s device time in the trace.
Nothing where the family has no scan, or where the launches are not one a
Mamba-2 layer and traced wave."""

from perfbench import counts

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "call_p95_s", "device_trace"
KERNEL = ("ssd_kernel",)


def read(r):
    launch = getattr(r.family, "ssd_launch", None)
    if r.trace is None or launch is None:
        return None
    layers = r.family.mamba_layers(r.conf)
    t = r.trace.kernel_seconds(*KERNEL)
    if t <= 0 or r.trace.kernel_launches(*KERNEL) != len(r.traced_waves) * layers:
        return None  # not the path this reader counts
    c = r.traffic.concurrency
    bound = sum(counts.roofline_seconds(*launch(r.conf, c, s)) for s in r.traced_waves) * layers
    return 100.0 * bound / t
