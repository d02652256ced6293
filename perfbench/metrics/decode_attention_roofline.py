"""The decode-attention kernel's share of its roofline over the traced
waves: every decode step of every layer reads the cache up to the step's
length (``counts.decode_launch``); its device time is that of the split-K
chunk kernel over dense rows and of the combine kernel after it."""

from perfbench import counts

UNIT, LAYER, MOVES, SOURCE = "%", "kernels", "calls_per_s", "device_trace"
CHUNK = ("decode_chunk_kernel", "DenseRows")
COMBINE = ("decode_combine_kernel",)


def read(r):
    a = r.family.attention_shapes(r.conf)
    if r.trace is None or a is None:
        return None
    t = r.trace.kernel_seconds(*CHUNK) + r.trace.kernel_seconds(*COMBINE)
    steps = r.traffic.max_new - 1
    if t <= 0 or r.trace.kernel_launches(*CHUNK) != len(r.traced_waves) * steps * a.layers:
        return None  # not the path this reader counts
    c = r.traffic.concurrency
    bound = sum(counts.roofline_seconds(*counts.decode_launch(a, c, s + j + 1))
                for s in r.traced_waves for j in range(steps)) * a.layers
    return 100.0 * bound / t
