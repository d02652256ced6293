"""Plain PyTorch versions of the ported kernels (twins of the oracles in
``repro.kernels.ref``), in the kernels' layout, with an fp32 softmax.

Deliberately naive: they materialize the scores. They are what the kernel
wrappers run for a tensor on the CPU, and what each CUDA kernel is held
against on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0.0 else s


def flash_attention_ref(q, k, v, *, causal: bool = True, logit_softcap: float = 0.0):
    """q: (B, Hq, S, hd); k, v: (B, Hkv, S, hd) -> (B, Hq, S, hd). fp32 math,
    output in q's dtype. ``logit_softcap`` > 0 caps the scores as the
    model's plain attention does (the CUDA kernel refuses it)."""
    B, Hq, S, hd = q.shape
    G = Hq // k.shape[1]
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(hd)
    s = _softcap(s, logit_softcap)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def decode_attention_ref(q, k, v, length, *, logit_softcap: float = 0.0):
    """q: (B, Hq, hd); k, v: (B, Hkv, M, hd); length: () or (B,) valid kv
    counts (a scalar broadcasts to the whole batch). Returns (B, Hq, hd)."""
    B, Hq, hd = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr) / math.sqrt(hd)
    s = _softcap(s, logit_softcap)
    lens = torch.as_tensor(length, dtype=torch.int32, device=q.device).reshape(-1)
    lens = lens.expand(B)
    mask = torch.arange(M, device=q.device)[None, None, :] >= lens[:, None, None]
    s = s.masked_fill(mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vr).to(q.dtype)
