"""Peak device memory of the run before the output check:
``torch.cuda.max_memory_allocated``, in GiB."""

UNIT, LAYER, MOVES, SOURCE = "GiB", "device", "calls_per_s", "program_counter"


def read(r):
    return r.memory_peak_bytes / 2**30 if r.memory_peak_bytes else None
