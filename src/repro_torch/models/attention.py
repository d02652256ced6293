"""Attention: GQA projections (+QKV bias), causal prefill attention and
single-token decode attention (the dense parts of ``repro.models.attention``).

Every causal prefill goes through ``kernels.ops.flash_attention_op`` and
every decode step through ``kernels.ops.decode_attention_op``: on a CUDA
tensor they launch the hand-written kernels, on a CPU tensor they run the
plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import Params, dense_init, dtype_of
from repro_torch.models.rope import apply_rope


def attn_init(cfg, generator, device) -> Params:
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p: Params = {
        "wq": dense_init(generator, (d, cfg.q_dim), dt, device),
        "wk": dense_init(generator, (d, cfg.kv_dim), dt, device),
        "wv": dense_init(generator, (d, cfg.kv_dim), dt, device),
        "wo": dense_init(generator, (cfg.q_dim, d), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, dtype=dt, device=device)
        p["bk"] = torch.zeros(cfg.kv_dim, dtype=dt, device=device)
        p["bv"] = torch.zeros(cfg.kv_dim, dtype=dt, device=device)
    return p


def _project_qkv(cfg, p: Params, x: torch.Tensor):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def attention_seq(cfg, p: Params, x: torch.Tensor, cos, sin):
    """Causal full-sequence attention (prefill). Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = kops.flash_attention_op(q, k, v, causal=True,
                                logit_softcap=cfg.attn_logit_softcap)
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    return out, (k, v)


def attention_decode(
    cfg,
    p: Params,
    x: torch.Tensor,
    cos,
    sin,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: int,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Single-token decode. x: (B, 1, D); cache: (B, M, Hkv, hd) in x's
    dtype. Writes the new token's K/V IN PLACE at position ``pos`` and
    attends over the first ``lengths[b]`` positions of row b ((B,) int32 on
    x's device; ``lm.decode_step`` passes ``pos + 1`` for every row).
    Returns out (B, 1, D).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)  # (B, 1, H*, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    o = kops.decode_attention_op(q, cache_k, cache_v, lengths,
                                 logit_softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]
