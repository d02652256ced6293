"""Launcher of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention``. The kernel
reads the cache in the model layout (B, M, Hkv, hd) through strides, masks
each row at its own length, and is batch-invariant (a row of a mixed batch
is bitwise equal to that row alone); its plain version is
``ref.decode_attention_ref``, and ``ref.decode_attention_split_ref`` repeats
its split-K arithmetic: the cache is cut into chunks of ``CHUNK`` positions,
each scored by its own CTA into fp32 partials (in a scratch allocated here),
which a second kernel of the same call combines in chunk order.
"""

from __future__ import annotations

import collections
from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_aligned16
from repro_torch.kernels.ref import NEG_INF  # noqa: F401  (the mask value: NEG in csrc/common.cuh)

CHUNK = 32  # cache positions per chunk CTA: DC in csrc/decode_common.cuh


def split_scratch(B: int, Hq: int, Hkv: int, M: int, hd: int, device) -> torch.Tensor:
    """The fp32 partials of a split-K decode over M cache positions: per
    (sequence, kv head, chunk), acc (G, hd) then (m, l) (G, 2)."""
    n_chunks = -(-M // CHUNK)
    return torch.empty(B * Hkv * n_chunks * (Hq // Hkv) * (hd + 2), dtype=torch.float32,
                       device=device)


# csrc/decode_attention.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "decode_attention_fwd"
ARGTYPES = [c_void_p] * 6 + [c_int64] + [c_int] * 6 + [c_int64] * 10 + [c_void_p]


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B, 1, Hq, hd); cache_k/v (B, M, Hkv, hd); lengths () or (B,) int
    valid counts, on one CUDA device -> (B, 1, Hq, hd). A length is clamped
    to [0, M]; a row of length 0 gives zeros (as the TPU kernel). Launches
    the kernel or raises."""
    dev = q.device
    if not (q.is_cuda and cache_k.device == dev and cache_v.device == dev
            and lengths.device == dev):
        raise ValueError("decode_attention: all inputs must be on one CUDA device")
    if q.dtype not in DTYPES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{cache_k.dtype}/"
                         f"{cache_v.dtype}; need one of float32, bfloat16 for all")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    B, _, Hq, hd = q.shape
    M, Hkv = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape[0] != B or cache_k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(cache_k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or cache_k.stride(-1) != 1 or cache_v.stride(-1) != 1:
        raise ValueError("decode_attention: the head dim must be contiguous")
    if lengths.dim() > 1 or lengths.numel() not in (1, B) or lengths.is_floating_point():
        raise ValueError(f"decode_attention: lengths shape {tuple(lengths.shape)}, "
                         f"need () or ({B},) integers")
    check_aligned16("decode_attention", cache_k, cache_v)
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    o = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return o
    scratch = split_scratch(B, Hq, Hkv, M, hd, dev)
    fn = _build.entry("decode_attention", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), scratch.data_ptr(), scratch.numel(), DTYPES[q.dtype],
            B, Hq, Hkv, M, hd,
            q.stride(0), q.stride(2),
            cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
            cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
            o.stride(0), o.stride(2),
            stream,
        )
    _build.check("decode_attention", code)
    decode_attention.launches += 1
    decode_attention.launches_by_hd[hd] += 1
    return o


decode_attention.launches = 0  # launches since the last reset
decode_attention.launches_by_hd = collections.Counter()  # the same, by head dim
