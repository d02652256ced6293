"""Launcher of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention``. The kernel
reads the cache in the model layout (B, M, Hkv, hd) through strides, masks
each row at its own length, and is batch-invariant (a row of a mixed batch
is bitwise equal to that row alone); its plain version is
``ref.decode_attention_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS


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
    lens = lengths.to(torch.int32).reshape(-1).expand(B).contiguous()
    o = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return o
    fn = _build.entry("decode_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), DTYPES[q.dtype], B, Hq, Hkv, M, hd,
            q.stride(0), q.stride(2),
            cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
            cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
            o.stride(0), o.stride(2),
            stream,
        )
    _build.check("decode_attention", code)
    decode_attention.launches += 1
    return o


decode_attention.launches = 0  # launches since the last reset
