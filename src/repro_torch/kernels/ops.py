"""Public wrappers for the kernels, in the model layout (the twins of
``repro.kernels.ops``).

Dispatch mirrors ``repro.kernels.ops._on_cpu``: a tensor on the CPU takes
the plain PyTorch version (``ref``); any other tensor goes to the CUDA
kernel, which launches or raises. There is no fallback from one to the
other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention


def flash_attention_op(q, k, v, *, causal: bool = True, logit_softcap: float = 0.0):
    """Model layout: q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    if q.device.type == "cpu":
        o = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, logit_softcap=logit_softcap,
        )
        return o.transpose(1, 2)
    if logit_softcap:
        raise ValueError("flash_attention kernel: attn_logit_softcap is not supported")
    return flash_attention(q, k, v, causal=causal)


def decode_attention_op(q, cache_k, cache_v, lengths, *, logit_softcap: float = 0.0):
    """q (B,1,Hq,hd); cache (B,M,Hkv,hd); lengths () or (B,) int32
    per-sequence valid counts -> (B,1,Hq,hd)."""
    if q.device.type == "cpu":
        o = ref.decode_attention_ref(
            q[:, 0], cache_k.transpose(1, 2), cache_v.transpose(1, 2), lengths,
            logit_softcap=logit_softcap,
        )
        return o[:, None]
    if logit_softcap:
        raise ValueError("decode_attention kernel: attn_logit_softcap is not supported")
    return decode_attention(q, cache_k, cache_v, torch.as_tensor(lengths, device=q.device))
