"""Launcher of the CUDA SSD scan kernel (``csrc/ssd.cu``).

Replaces ``repro/kernels/ssd.py::ssd``. The kernel runs the Mamba-2
recurrence step by step from a zero state, reads x (B, S, H, P), dt
(B, S, H) and B_/C_ (B, S, Ns), shared by every head, or (B, S, G, Ns),
head h reading group h // (H / G), in the model layout through strides
(the model's views of its projection, used in place), takes any S, and
returns y in fp32 (as the model's chunked form does) with the final fp32
state; its plain version is ``ref.ssd_chunked_ref``. It copies x, B_ and
C_ with 16-byte cp.async, so it takes only tensors whose data pointers and
strides are 16-byte aligned (``check_aligned16``); the model's are.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_aligned16

# (P, Ns): zamba2-2.7b's (64, 64), Nemotron-H's (64, 128) and (64, 256), and
# the JAX package's sweeps' shapes
SHAPES = ((32, 16), (32, 32), (32, 64), (64, 16), (64, 32), (64, 64), (64, 128), (64, 256))


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor, B_: torch.Tensor,
        C_: torch.Tensor, D: torch.Tensor):
    """x (B, S, H, P) and B_/C_ (B, S, Ns) or (B, S, G, Ns) with G dividing
    H, in float32 or bfloat16 (one type), dt (B, S, H) and A_log, D (H,) in
    float32, on one CUDA device -> (y (B, S, H, P) float32, state (B, H, P,
    Ns) float32). Launches the kernel or raises."""
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A_log, B_, C_, D))):
        raise ValueError("ssd: x, dt, A_log, B_, C_, D must be on one CUDA device")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise ValueError(f"ssd: dtypes x {x.dtype}, B_ {B_.dtype}, C_ {C_.dtype}; need "
                         "one of float32, bfloat16 for all three")
    if any(t.dtype != torch.float32 for t in (dt, A_log, D)):
        raise ValueError(f"ssd: dt {dt.dtype}, A_log {A_log.dtype}, D {D.dtype} must be "
                         "float32")
    if x.dim() != 4 or B_.dim() not in (3, 4) or B_.shape != C_.shape:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, B_ {tuple(B_.shape)}, "
                         f"C_ {tuple(C_.shape)}")
    if B_.dim() == 3:  # one group: B_ and C_ shared by every head
        B_, C_ = B_.unsqueeze(2), C_.unsqueeze(2)
    Bb, S, H, P = x.shape
    G, Ns = B_.shape[2:]
    if (tuple(dt.shape) != (Bb, S, H) or tuple(B_.shape[:2]) != (Bb, S) or H % G
            or tuple(A_log.shape) != (H,) or tuple(D.shape) != (H,)):
        raise ValueError(f"ssd: x {tuple(x.shape)} vs dt {tuple(dt.shape)}, B_ "
                         f"{tuple(B_.shape)}, A_log {tuple(A_log.shape)}, D {tuple(D.shape)}")
    if (P, Ns) not in SHAPES:
        raise ValueError(f"ssd: (head dim, state dim) {(P, Ns)} not in {SHAPES}")
    if x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1:
        raise ValueError("ssd: the last dims of x, B_ and C_ must be contiguous")
    check_aligned16("ssd", x, B_, C_)
    A_log, D = A_log.contiguous(), D.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    state = torch.zeros((Bb, H, P, Ns), dtype=torch.float32, device=dev)
    if Bb == 0 or S == 0 or H == 0:
        return y, state
    fn = _build.entry("ssd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[x.dtype], Bb, S, H, G, P, Ns,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
            B_.stride(0), B_.stride(1), B_.stride(2), C_.stride(0), C_.stride(1), C_.stride(2),
            stream,
        )
    _build.check("ssd", code)
    ssd.launches += 1
    return y, state


ssd.launches = 0  # launches since the last reset
