"""Launcher of the CUDA wkv6 kernel (``csrc/wkv6.cu``).

Replaces ``repro/kernels/rwkv6.py::wkv6``. The kernel runs the RWKV6
recurrence step by step from a zero state, reads r, k, v and w_log in the
model layout (B, S, H, N) through strides, takes any S, and returns y in
fp32 (as the model's chunked form does) with the final fp32 state; its
plain version is ``ref.wkv6_chunked_ref``. It copies r, k, v and w_log with
16-byte cp.async, so it takes only tensors whose data pointers and strides
are 16-byte aligned (``check_aligned16``); the model's are.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_aligned16

HEAD_SIZES = (16, 32, 64)


def _strides3(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


# csrc/wkv6.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "wkv6_fwd"
ARGTYPES = [c_void_p] * 7 + [c_int] * 5 + [c_int64] * 12 + [c_void_p]


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w_log: torch.Tensor,
         u: torch.Tensor):
    """r, k, v (B, S, H, N) in float32 or bfloat16, w_log (B, S, H, N) and u
    (H, N) in float32, on one CUDA device -> (y (B, S, H, N) float32,
    state (B, H, N, N) float32). Launches the kernel or raises."""
    dev = r.device
    if not (r.is_cuda and all(t.device == dev for t in (k, v, w_log, u))):
        raise ValueError("wkv6: r, k, v, w_log, u must be on one CUDA device")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: dtypes {r.dtype}/{k.dtype}/{v.dtype}; need one of "
                         "float32, bfloat16 for r, k and v")
    if w_log.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"wkv6: w_log {w_log.dtype} and u {u.dtype} must be float32")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w_log.shape):
        raise ValueError(f"wkv6: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w_log {tuple(w_log.shape)}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, need ({H}, {N})")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {N} not in {HEAD_SIZES}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w_log)):
        raise ValueError("wkv6: the head dim must be contiguous")
    check_aligned16("wkv6", r, k, v, w_log)
    u = u.contiguous()
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
    if B == 0 or S == 0 or H == 0:
        return y, state
    fn = _build.entry("wkv6", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(), u.data_ptr(),
            y.data_ptr(), state.data_ptr(), DTYPES[r.dtype], B, S, H, N,
            *_strides3(r), *_strides3(k), *_strides3(v), *_strides3(w_log),
            stream,
        )
    _build.check("wkv6", code)
    wkv6.launches += 1
    return y, state


wkv6.launches = 0  # launches since the last reset
