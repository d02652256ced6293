"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention``. The kernel
reads the model layout (B, S, H, hd) through strides, takes any S and masks
the ragged tail itself; its plain version is ``ref.flash_attention_ref``.
In bf16 it runs on the tensor cores (mma.sync) and copies K/V tiles with
16-byte cp.async, so it takes bf16 tensors whose data pointers and strides
are 16-byte aligned (``check_aligned16``); fp32 runs exact CUDA-core FMAs.
"""

from __future__ import annotations

import collections
from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF  # noqa: F401  (the mask value: NEG in csrc/common.cuh)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)


def check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless each tensor's data pointer, and its stride
    in bytes along every dimension of size above 1 but the last, is a
    multiple of 16: the kernels copy rows with 16-byte cp.async."""
    for t in tensors:
        esz = t.element_size()
        if t.data_ptr() % 16 or any(st * esz % 16 for n, st in zip(t.shape[:-1], t.stride()[:-1])
                                    if n > 1):
            raise ValueError(f"{name}: a {tuple(t.shape)} tensor with strides {t.stride()} "
                             "is not 16-byte aligned (data pointer and row strides)")


# csrc/flash_attention.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "flash_attention_fwd"
ARGTYPES = [c_void_p] * 4 + [c_int] * 7 + [c_int64] * 12 + [c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Model layout: q (B, S, Hq, hd), k/v (B, S, Hkv, hd) on a CUDA device
    -> (B, S, Hq, hd) in q's dtype. Launches the kernel or raises."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "need one of float32, bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        check_aligned16("flash_attention", q, k, v)
    o = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    if S == 0 or B == 0:
        return o
    fn = _build.entry("flash_attention", SYMBOL, ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], B, S, Hq, Hkv, hd, int(causal),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            stream,
        )
    _build.check("flash_attention", code)
    flash_attention.launches += 1
    flash_attention.launches_by_hd[hd] += 1
    flash_attention.launches_by_causal[bool(causal)] += 1
    return o


flash_attention.launches = 0  # launches since the last reset
flash_attention.launches_by_hd = collections.Counter()  # the same, by head dim
flash_attention.launches_by_causal = collections.Counter()  # the same, by causal
