"""Launcher of the CUDA paged decode-attention kernel
(``csrc/paged_decode_attention.cu``).

Replaces ``repro/kernels/paged_attention.py::paged_decode_attention``. The
kernel reads K/V from the page pool's (N, page_size, Hkv, hd) slabs through a
(B, P) page table (-1 past a sequence's last page, clamped to row 0 and
masked by the length), with the dense decode kernel's chunk body and combine
(``csrc/decode_common.cuh``): it is bitwise equal to ``decode_attention`` on
the cache gathered in table order. Its plain version is
``ref.paged_attention_ref``.
"""

from __future__ import annotations

import collections
from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import split_scratch
from repro_torch.kernels.flash_attention import DTYPES, check_aligned16
from repro_torch.kernels.ref import NEG_INF  # noqa: F401  (the mask value: NEG in csrc/common.cuh)

HEAD_DIMS = (32, 64, 128)


# csrc/paged_decode_attention.cu's entry point and the ctypes of the call below's
# arguments, in order
SYMBOL = "paged_decode_attention_fwd"
ARGTYPES = [c_void_p] * 7 + [c_int64] + [c_int] * 8 + [c_int64] * 10 + [c_void_p]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q (B, 1, Hq, hd); k_pages/v_pages (N, page_size, Hkv, hd); page_table
    (B, P) int pool rows; lengths () or (B,) int valid counts, on one CUDA
    device -> (B, 1, Hq, hd). A length is clamped to [0, P * page_size]; a
    row of length 0 gives zeros. Launches the kernel or raises."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k_pages, v_pages, page_table,
                                                         lengths))):
        raise ValueError("paged_decode_attention: all inputs must be on one CUDA device")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention: dtypes {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}; need one of float32, bfloat16 for all")
    if (q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4
            or k_pages.shape != v_pages.shape):
        raise ValueError(f"paged_decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, _, Hq, hd = q.shape
    N, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape[3] != hd or Hq % Hkv or N == 0 or ps == 0:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} vs pages "
                         f"{tuple(k_pages.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError("paged_decode_attention: the head dim must be contiguous")
    if (page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] == 0
            or page_table.is_floating_point()):
        raise ValueError(f"paged_decode_attention: page_table shape "
                         f"{tuple(page_table.shape)}, need ({B}, P >= 1) integers")
    if lengths.dim() > 1 or lengths.numel() not in (1, B) or lengths.is_floating_point():
        raise ValueError(f"paged_decode_attention: lengths shape {tuple(lengths.shape)}, "
                         f"need () or ({B},) integers")
    check_aligned16("paged_decode_attention", k_pages, v_pages)
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    o = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return o
    scratch = split_scratch(B, Hq, Hkv, table.shape[1] * ps, hd, dev)
    fn = _build.entry("paged_decode_attention", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
            lens.data_ptr(), o.data_ptr(), scratch.data_ptr(), scratch.numel(),
            DTYPES[q.dtype], B, Hq, Hkv, N, ps,
            table.shape[1], hd,
            q.stride(0), q.stride(2),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            o.stride(0), o.stride(2),
            stream,
        )
    _build.check("paged_decode_attention", code)
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_hd[hd] += 1
    return o


paged_decode_attention.launches = 0  # launches since the last reset
paged_decode_attention.launches_by_hd = collections.Counter()  # the same, by head dim
