"""Hand-written Hopper kernels, their plain PyTorch versions and wrappers.

Each launcher module declares its kernel's C entry point (``SYMBOL``,
``ARGTYPES``) beside the call that passes the arguments. Each wrapper
counts its kernel's launches in ``<wrapper>.launches`` (and, for the
attention kernels, in ``launches_by_*`` breakdowns); ``launchers`` is the
table of the eight by name and ``reset_counts`` sets their counters to 0.
``counts`` copies them and ``add_counts`` adds a difference of two copies:
a CUDA graph replays launches that no wrapper counts, so the engine adds,
at each replay, what the wrappers counted while it captured."""

import collections
import importlib

# each kernel (its csrc/<name>.cu and its wrapper's name) -> its launcher module
_LAUNCHER_MODULES = {
    "flash_attention": "flash_attention",
    "decode_attention": "decode_attention",
    "paged_decode_attention": "paged_attention",
    "topk_cosine": "similarity",
    "wkv6": "rwkv6",
    "ssd": "ssd",
    "ssd_step": "ssd_step",
    "causal_conv": "causal_conv",
}
KERNELS = tuple(_LAUNCHER_MODULES)


def launchers() -> dict:
    """Each kernel's wrapper by name, in ``KERNELS``' order."""
    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), name)
            for name, mod in _LAUNCHER_MODULES.items()}


def reset_counts() -> dict:
    """Every launch counter of ``launchers()`` to 0, the totals and the
    ``launches_by_*`` breakdowns. Returns ``launchers()``."""
    kernels = launchers()
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
