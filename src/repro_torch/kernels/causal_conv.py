"""Launcher of the CUDA causal conv kernel (``csrc/causal_conv.cu``).

Replaces no TPU kernel: the JAX package's Mamba-2 conv
(``repro/models/mamba.py::_causal_conv``) is plain jnp, as the port's plain
version ``kernels/ref.py::causal_conv_ref`` is. The kernel runs a prefill's
depthwise causal conv over 4 taps, adds the bias and applies SiLU in one
pass: it reads xc (B, S, CH) through its strides (the model's column slice
of the ``in_proj`` output, used as it is) and the carry once, accumulates
in fp32, and writes the output and the new carry in xc's dtype, bit for
bit the plain version's. Its bytes bound it. It copies xc with 16-byte cp.async, so it takes only an xc whose
data pointer and strides are 16-byte aligned (``check_aligned16``); the
model's is.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_aligned16

TAPS = 4  # every SSMConfig.conv_dim of the registry
CHANNELS = 8  # CH must be a multiple of the 8 channels a thread takes

# csrc/causal_conv.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "causal_conv_fwd"
ARGTYPES = [c_void_p] * 6 + [c_int] * 5 + [c_int64] * 4 + [c_void_p]


def causal_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                prev: Optional[torch.Tensor] = None):
    """xc (B, S, CH) in float32 or bfloat16, its channels contiguous and its
    rows 16-byte aligned; w (K, CH) and b (CH,) float32; prev (B, K-1, CH)
    in xc's dtype or None (zeros); all on one CUDA device, K = 4, CH a
    multiple of 8 -> (y (B, S, CH) in xc's dtype, carry (B, K-1, CH)), the
    carry the last K-1 rows of [prev, xc]. Launches the kernel or raises."""
    dev = xc.device
    given = [xc, w, b] + ([] if prev is None else [prev])
    if any(t.device != dev for t in given):
        raise ValueError("causal_conv: xc, w, b and prev must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise ValueError("causal_conv kernel: an input requires grad and the kernel has no "
                         "backward (train through lm.forward(..., use_kernels=False))")
    if xc.dtype not in DTYPES or (prev is not None and prev.dtype != xc.dtype):
        raise ValueError(f"causal_conv: dtypes xc {xc.dtype}, prev "
                         f"{None if prev is None else prev.dtype}; need one of float32, "
                         "bfloat16 for both")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"causal_conv: w {w.dtype}, b {b.dtype} must be float32")
    if xc.dim() != 3 or w.dim() != 2:
        raise ValueError(f"causal_conv: shapes xc {tuple(xc.shape)}, w {tuple(w.shape)}")
    Bb, S, CH = xc.shape
    K = w.shape[0]
    if K != TAPS:
        raise ValueError(f"causal_conv: {K} taps; the kernel takes {TAPS}")
    if (tuple(w.shape) != (K, CH) or tuple(b.shape) != (CH,)
            or (prev is not None and tuple(prev.shape) != (Bb, K - 1, CH))):
        raise ValueError(f"causal_conv: xc {tuple(xc.shape)} vs w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, prev {None if prev is None else tuple(prev.shape)}")
    if CH % CHANNELS:
        raise ValueError(f"causal_conv: {CH} channels, not a multiple of {CHANNELS}")
    if xc.stride(-1) != 1 or (prev is not None and prev.stride(-1) != 1):
        raise ValueError("causal_conv: the channels of xc and prev must be contiguous")
    check_aligned16("causal_conv", xc)
    if not xc.is_cuda:
        raise ValueError("causal_conv: the tensors must be on a CUDA device")
    w, b = w.contiguous(), b.contiguous()
    y = torch.empty((Bb, S, CH), dtype=xc.dtype, device=dev)
    if Bb == 0 or S == 0 or CH == 0:  # the carry is [prev, xc]'s last K-1 rows: prev's
        carry = (torch.zeros((Bb, K - 1, CH), dtype=xc.dtype, device=dev) if prev is None
                 else prev.clone(memory_format=torch.contiguous_format))
        return y, carry
    carry = torch.empty((Bb, K - 1, CH), dtype=xc.dtype, device=dev)
    fn = _build.entry("causal_conv", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            xc.data_ptr(), None if prev is None else prev.data_ptr(), w.data_ptr(),
            b.data_ptr(), y.data_ptr(), carry.data_ptr(), DTYPES[xc.dtype], Bb, S, CH, K,
            xc.stride(0), xc.stride(1), 0 if prev is None else prev.stride(0),
            0 if prev is None else prev.stride(1), stream,
        )
    _build.check("causal_conv", code)
    causal_conv.launches += 1
    return y, carry


causal_conv.launches = 0  # launches since the last reset
