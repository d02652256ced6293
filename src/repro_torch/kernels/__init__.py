"""Hand-written Hopper kernels, their plain PyTorch versions and wrappers.

Each wrapper counts its kernel's launches in ``<wrapper>.launches`` (and,
for the attention kernels, in ``launches_by_*`` breakdowns); ``launchers``
is the table of the seven by name and ``reset_counts`` sets their counters
to 0. ``counts`` copies them and ``add_counts`` adds a difference of two
copies: a CUDA graph replays launches that no wrapper counts, so the
engine adds, at each replay, what the wrappers counted while it captured."""

import collections

KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention", "topk_cosine",
           "wkv6", "ssd", "ssd_step")


def launchers() -> dict:
    """Each kernel's wrapper by name, in ``KERNELS``' order."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.similarity import topk_cosine
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.ssd_step import ssd_step

    return dict(zip(KERNELS, (flash_attention, decode_attention, paged_decode_attention,
                              topk_cosine, wkv6, ssd, ssd_step)))


def reset_counts(kernels: dict = None) -> dict:
    """Every launch counter of ``kernels`` (default: all of ``launchers()``)
    to 0, the totals and the ``launches_by_*`` breakdowns. Returns
    ``kernels``."""
    kernels = launchers() if kernels is None else kernels
    for fn in kernels.values():
        fn.launches = 0
        for name in _BREAKDOWNS:
            if hasattr(fn, name):
                getattr(fn, name).clear()
    return kernels


_BREAKDOWNS = ("launches_by_hd", "launches_by_causal")


def counts() -> dict:
    """A copy of every launch counter of ``launchers()``: {(kernel,
    counter): value}, the totals ints and the breakdowns Counters."""
    out = {}
    for name, fn in launchers().items():
        out[name, "launches"] = fn.launches
        for b in _BREAKDOWNS:
            if hasattr(fn, b):
                out[name, b] = collections.Counter(getattr(fn, b))
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a difference of two ``counts()``, taken
    key by key) to the counters in place; a breakdown keeps no zero entry."""
    fns = launchers()
    for (name, counter), v in delta.items():
        fn = fns[name]
        if counter == "launches":
            fn.launches += sign * v
            continue
        c = getattr(fn, counter)
        for k, n in v.items():
            c[k] += sign * n
            if not c[k]:
                del c[k]
