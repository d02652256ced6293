"""Launcher of the CUDA SSD decode-step kernel (``csrc/ssd_step.cu``).

Replaces no TPU kernel: the JAX package's decode step
(``repro/models/mamba.py::ssd_step``) is plain jnp, as the port's plain
version ``models/mamba.py::ssd_step`` is. The kernel takes one step of the
Mamba-2 recurrence and updates the fp32 state **in place**, reading it once
and writing it once; the bytes of the state bound it. It reads x (B, H, P)
and B_/C_ (B, Ns), shared by every head, or (B, G, Ns), head h reading group
h // (H / G), through strides (the model's views of its conv output, used as
they are), and returns y in fp32.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ssd import SHAPES


# csrc/ssd_step.cu's entry point and the ctypes of the call below's arguments, in order
SYMBOL = "ssd_step_fwd"
ARGTYPES = [c_void_p] * 8 + [c_int] * 6 + [c_int64] * 8 + [c_void_p]


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, D: torch.Tensor, state: torch.Tensor):
    """x (B, H, P) and B_/C_ (B, Ns) or (B, G, Ns) with G dividing H, in
    float32 or bfloat16 (one type), dt (B, H), A_log and D (H,) and state
    (B, H, P, Ns) in float32, state contiguous, all on one CUDA device ->
    (y (B, H, P) float32, state), the state updated in place. Launches the
    kernel or raises."""
    dev = state.device
    if any(t.device != dev for t in (x, dt, A_log, B_, C_, D)):
        raise ValueError("ssd_step: x, dt, A_log, B_, C_, D and state must be on one device")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise ValueError(f"ssd_step: dtypes x {x.dtype}, B_ {B_.dtype}, C_ {C_.dtype}; need "
                         "one of float32, bfloat16 for all three")
    if any(t.dtype != torch.float32 for t in (dt, A_log, D, state)):
        raise ValueError(f"ssd_step: dt {dt.dtype}, A_log {A_log.dtype}, D {D.dtype}, state "
                         f"{state.dtype} must be float32")
    if x.dim() != 3 or B_.dim() not in (2, 3) or B_.shape != C_.shape or state.dim() != 4:
        raise ValueError(f"ssd_step: shapes x {tuple(x.shape)}, B_ {tuple(B_.shape)}, "
                         f"C_ {tuple(C_.shape)}, state {tuple(state.shape)}")
    if B_.dim() == 2:  # one group: B_ and C_ shared by every head
        B_, C_ = B_.unsqueeze(1), C_.unsqueeze(1)
    Bb, H, P = x.shape
    G, Ns = B_.shape[1:]
    if (tuple(dt.shape) != (Bb, H) or B_.shape[0] != Bb or H % G
            or tuple(A_log.shape) != (H,) or tuple(D.shape) != (H,)
            or tuple(state.shape) != (Bb, H, P, Ns)):
        raise ValueError(f"ssd_step: x {tuple(x.shape)} vs dt {tuple(dt.shape)}, B_ "
                         f"{tuple(B_.shape)}, A_log {tuple(A_log.shape)}, D {tuple(D.shape)}, "
                         f"state {tuple(state.shape)}")
    if (P, Ns) not in SHAPES:
        raise ValueError(f"ssd_step: (head dim, state dim) {(P, Ns)} not in {SHAPES}")
    if x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError("ssd_step: the last dims of x, B_ and C_ must be contiguous")
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("ssd_step: the state must be contiguous and 16-byte aligned "
                         "(it is updated in place)")
    if not state.is_cuda:
        raise ValueError("ssd_step: the tensors must be on a CUDA device")
    A_log, D = A_log.contiguous(), D.contiguous()
    y = torch.empty((Bb, H, P), dtype=torch.float32, device=dev)
    if Bb == 0 or H == 0:
        return y, state
    fn = _build.entry("ssd_step", SYMBOL, ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[x.dtype], Bb, H, G, P, Ns,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), B_.stride(0), B_.stride(1),
            C_.stride(0), C_.stride(1), stream,
        )
    _build.check("ssd_step", code)
    ssd_step.launches += 1
    return y, state


ssd_step.launches = 0  # launches since the last reset
