"""Attention: GQA projections (+QKV bias, +qk-norm), prefill attention
(causal, or bidirectional for whisper's encoder), single-token decode
attention, the chunked-prefill continuation over a stored prefix, and
whisper's cross-attention (the port of ``repro.models.attention``).

Every prefill goes through ``kernels.ops.flash_attention_op`` and every
decode step through ``kernels.ops.decode_attention_op``: on a CUDA tensor
they launch the hand-written kernels, on a CPU tensor they run the plain
versions. ``attention_extend`` and the cross-attention are plain PyTorch on
both, as the reference computes them outside any kernel. RoPE is skipped
where ``cos`` is None (``rope_type="none"``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import Params, dense_init, dtype_of, rms_norm
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
    if cfg.qk_norm:
        p["q_norm_scale"] = torch.ones(cfg.head_dim, dtype=torch.float32, device=device)
        p["k_norm_scale"] = torch.ones(cfg.head_dim, dtype=torch.float32, device=device)
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
    if cfg.qk_norm:  # per-head RMSNorm over head_dim, fp32 scales
        q = rms_norm(q, p["q_norm_scale"])
        k = rms_norm(k, p["k_norm_scale"])
    return q, k, v


def _rope(q, k, cos, sin):
    if cos is None:
        return q, k
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def attention_seq(cfg, p: Params, x: torch.Tensor, cos, sin, *, causal: bool = True):
    """Full-sequence attention (prefill; ``causal=False`` for an encoder).
    Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope(q, k, cos, sin)
    o = kops.flash_attention_op(q, k, v, causal=causal,
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
    q, k = _rope(q, k, cos, sin)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    o = kops.decode_attention_op(q, cache_k, cache_v, lengths,
                                 logit_softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def attention_extend(cfg, p: Params, x: torch.Tensor, cos, sin,
                     prefix_k: torch.Tensor, prefix_v: torch.Tensor, prefix_len: int):
    """Chunked-prefill continuation: the suffix attends over a prefilled
    prefix plus itself causally.

    x: (B, S, D) suffix activations; prefix_k/v: (B, Sp, Hkv, hd) cached
    post-RoPE prefix K/V (Sp >= prefix_len; positions past ``prefix_len``
    are page padding and are masked out). cos/sin are taken at positions
    offset by ``prefix_len``. Scores and softmax in fp32.
    Returns (out (B, S, D), (k_suf, v_suf)).
    """
    B, S, _ = x.shape
    Sp = prefix_k.shape[1]
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope(q, k, cos, sin)
    keys = torch.cat([prefix_k.to(q.dtype), k], dim=1)
    vals = torch.cat([prefix_v.to(q.dtype), v], dim=1)
    M = Sp + S
    Hkv = keys.shape[2]
    hd = cfg.head_dim
    G = cfg.num_heads // Hkv
    # per-query mask: prefix keys below prefix_len are always visible;
    # suffix keys are causal relative to the suffix row
    row = torch.arange(S, device=x.device)[:, None]
    col = torch.arange(M, device=x.device)[None, :]
    visible = torch.where(col < Sp, col < prefix_len, (col - Sp) <= row)
    qg = q.reshape(B, S, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys.float()) / math.sqrt(hd)
    cap = cfg.attn_logit_softcap
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    s = s.masked_fill(~visible, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, vals.float())
    out = o.reshape(B, S, cfg.q_dim).to(q.dtype) @ p["wo"]
    return out, (k, v)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_init(cfg, generator, device) -> Params:
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    return {
        "wq": dense_init(generator, (d, cfg.q_dim), dt, device),
        "wk": dense_init(generator, (d, cfg.kv_dim), dt, device),
        "wv": dense_init(generator, (d, cfg.kv_dim), dt, device),
        "wo": dense_init(generator, (cfg.q_dim, d), dt, device),
    }


def cross_attention_kv(cfg, p: Params, enc_out: torch.Tensor):
    """Cross K/V from the encoder output (once per request): (B, T, Hkv, hd) each."""
    B, T, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def cross_attention(cfg, p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor):
    """x (B, S, D) attends over every encoder position of ck/cv (B, T, Hkv,
    hd): the reference's ``naive_attention(causal=False)``, scores and
    softmax in fp32. Returns (B, S, D)."""
    B, S, _ = x.shape
    hd, Hkv = cfg.head_dim, ck.shape[2]
    q = (x @ p["wq"]).reshape(B, S, Hkv, cfg.num_heads // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, ck.float()) / math.sqrt(hd)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), cv.float())
    return o.reshape(B, S, cfg.q_dim).to(x.dtype) @ p["wo"]
