"""Hand-written Hopper kernels, their plain PyTorch versions and wrappers.

Each wrapper counts its kernel's launches in ``<wrapper>.launches`` (and,
for the attention kernels, in ``launches_by_*`` breakdowns); ``launchers``
is the table of the six by name and ``reset_counts`` sets their counters
to 0."""

KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention", "topk_cosine",
           "wkv6", "ssd")


def launchers() -> dict:
    """Each kernel's wrapper by name, in ``KERNELS``' order."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.similarity import topk_cosine
    from repro_torch.kernels.ssd import ssd

    return dict(zip(KERNELS, (flash_attention, decode_attention, paged_decode_attention,
                              topk_cosine, wkv6, ssd)))


def reset_counts(kernels: dict = None) -> dict:
    """Every launch counter of ``kernels`` (default: all of ``launchers()``)
    to 0, the totals and the ``launches_by_*`` breakdowns. Returns
    ``kernels``."""
    kernels = launchers() if kernels is None else kernels
    for fn in kernels.values():
        fn.launches = 0
        for name in ("launches_by_hd", "launches_by_causal"):
            if hasattr(fn, name):
                getattr(fn, name).clear()
    return kernels
