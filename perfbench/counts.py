"""Operations and bytes computed from shapes, and the chip's peaks.

These are the benchmark's own yardstick, shared by every model family:
each attention kernel's operations and bytes (for its share of the
roofline) and the arithmetic a family's module (``references/<name>.py``)
counts a call's model FLOPs with (for the whole step's share of peak).
Nothing here reads the program.

Counting rules:

* A matrix product of (m, k) by (k, n) is 2·m·k·n operations.
* Causal attention over S positions counts the causal half, diagonal
  included: S·(S+1)/2 query-key pairs, 4·hd operations each (QKᵀ and PV).
* The head counts only the positions ``generate`` samples from: the last
  prompt position and each decode step.
* A kernel's bytes count each input byte read once and each output byte
  written once, at the tensors' element sizes; a decode step reads the
  cache up to its length, not its capacity.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Attn:
    """The attention shapes a kernel's counts need; a family's module
    (``references/<name>.py``) gives them for its configuration."""

    layers: int  # layers with attention: launches of each kernel a step
    heads: int
    kv_heads: int
    head_dim: int
    elem_bytes: int = 2  # bf16 activations and cache


def matmul_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attention_flops(a: Attn, query_key_pairs: int) -> float:
    """Operations of attention over ``query_key_pairs`` (one head group
    counted per query head)."""
    return 4.0 * a.heads * a.head_dim * query_key_pairs


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def decode_pairs(prompt_len: int, steps: int) -> int:
    """Query-key pairs of ``steps`` decode steps after a prompt of
    ``prompt_len``: step j attends to ``prompt_len + j + 1`` positions."""
    return steps * prompt_len + steps * (steps + 1) // 2


def flash_launch(a: Attn, batch: int, seq: int):
    """(operations, bytes) of one causal prefill attention launch:
    q, k, v read and o written once."""
    flops = attention_flops(a, causal_pairs(seq)) * batch
    elems = batch * seq * a.head_dim * (2 * a.heads + 2 * a.kv_heads)
    return flops, elems * a.elem_bytes


def decode_launch(a: Attn, batch: int, length: int):
    """(operations, bytes) of one decode attention launch over ``length``
    cached positions a row: q and the cache's K and V up to ``length``
    read, o written, the lengths (int32) read."""
    flops = attention_flops(a, length) * batch
    elems = batch * (2 * a.heads * a.head_dim + 2 * length * a.kv_heads * a.head_dim)
    return flops, elems * a.elem_bytes + 4 * batch


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def idle_share(busy_s: float, wall_s: float) -> float:
    """``1 - busy / wall``: the share of the wall time with no operation on
    the device (the arithmetic of ``repro_torch/launch/profile_serve.py``)."""
    return 1.0 - busy_s / wall_s
