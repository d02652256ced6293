"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (the port
of ``repro.models.rope``).

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


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL splits the half-dims into (temporal, height, width) sections:
    (half/4, 3*half/8, 3*half/8), (16, 24, 24) at hd 128."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    w = half - t - h
    return t, h, w


def mrope_angles(positions_3d: torch.Tensor, head_dim: int, theta: float) -> Tuple:
    """positions_3d: (3, B, S) [temporal, height, width] -> fp32 (cos, sin)
    (B, S, half); each frequency band takes its angle from its section's
    position stream."""
    cos, sin = rope_angles(positions_3d, head_dim, theta)  # (3, B, S, half)
    t, h, _ = mrope_sections(head_dim)

    def pick(a):
        return torch.cat([a[0, ..., :t], a[1, ..., t:t + h], a[2, ..., t + h:]], dim=-1)

    return pick(cos), pick(sin)


def positions_for_rope(cfg, positions: torch.Tensor, head_dim: int):
    """Dispatch on ``cfg.rope_type``. positions: (B, S) int, or (3, B, S)
    for mrope (text-only (B, S) positions are replicated over the three
    streams). Returns (cos, sin), or (None, None) for ``"none"``."""
    if cfg.rope_type == "none":
        return None, None
    if cfg.rope_type == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return mrope_angles(positions, head_dim, cfg.rope_theta)
    return rope_angles(positions, head_dim, cfg.rope_theta)
