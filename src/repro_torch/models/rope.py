"""Rotary position embeddings (``repro.models.rope``'s standard RoPE).

Positions are explicit, so prefill and decode share one code path.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple:
    """positions: (...,) int -> fp32 cos/sin of shape positions.shape + (head_dim/2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) broadcast over heads.

    The 'split-half' convention (x = [x1, x2]) of Llama/Qwen, not the
    interleaved one. Computes in fp32 and casts back to x's dtype.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
