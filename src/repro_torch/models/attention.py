"""Attention: GQA projections (+QKV bias, +qk-norm), prefill attention
(causal, or bidirectional for whisper's encoder), single-token decode
attention, the chunked-prefill continuation over a stored prefix, and
whisper's cross-attention (the port of ``repro.models.attention``).

Every prefill goes through ``kernels.ops.flash_attention_op`` and every
decode step through ``kernels.ops.decode_attention_op``: on a CUDA tensor
they launch the hand-written kernels, on a CPU tensor they run the plain
versions. ``attention_extend`` and the cross-attention are plain PyTorch on
both, as the reference computes them outside any kernel. Training
(``attention_seq(use_kernels=False)``) runs the reference's model code with
autograd: ``naive_attention``, or ``flash_attention_chunked`` past 512
positions. RoPE is skipped where ``cos`` is None (``rope_type="none"``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import Params, dense_init, dtype_of, rms_norm
from repro_torch.models.rope import apply_rope

ATTN_CHUNK = 2048  # the reference's attn_chunk (no config changes it)


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


def naive_attention(q, k, v, *, causal: bool = True, logit_softcap: float = 0.0):
    """Softmax attention with the scores materialized, fp32 (the reference's
    ``naive_attention``). q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd) ->
    (B, S, Hq, hd) in q's dtype."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(B, S, Hq, hd).to(q.dtype)


def flash_attention_chunked(q, k, v, *, chunk: int = ATTN_CHUNK, causal: bool = True,
                            logit_softcap: float = 0.0):
    """Online-softmax attention over (chunk x chunk) blocks, fp32
    accumulators (the reference's ``flash_attention_jnp``): the (S, S)
    scores are never held whole. Same layouts as ``naive_attention``."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    C = min(chunk, S)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i0 in range(0, S, C):
        qb = q[:, i0:i0 + C].reshape(B, -1, Hkv, G, hd).float()
        Cq = qb.shape[1]
        m = torch.full((B, Hkv, G, Cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, Cq, hd), dtype=torch.float32, device=q.device)
        for j0 in range(0, (i0 + C) if causal else S, C):
            kb, vb = k[:, j0:j0 + C].float(), v[:, j0:j0 + C].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            if logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            if causal and j0 == i0:
                r = torch.arange(Cq, device=q.device)
                s = s.masked_fill(r[None, :kb.shape[1]] > r[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pb = torch.exp(s - m_new[..., None])
            l = l * alpha + pb.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pb, vb)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)  # (B, Hkv, G, Cq, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, Cq, Hq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_seq(cfg, p: Params, x: torch.Tensor, cos, sin, *, causal: bool = True,
                  use_kernels: bool = True):
    """Full-sequence attention (prefill or training; ``causal=False`` for
    an encoder). ``use_kernels`` sends it to ``flash_attention_op``; else
    the reference's training path, ``naive_attention`` up to 512 positions
    and ``flash_attention_chunked`` past them. Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope(q, k, cos, sin)
    cap = cfg.attn_logit_softcap
    if use_kernels:
        o = kops.flash_attention_op(q, k, v, causal=causal, logit_softcap=cap)
    elif S > 512:
        o = flash_attention_chunked(q, k, v, causal=causal, logit_softcap=cap)
    else:
        o = naive_attention(q, k, v, causal=causal, logit_softcap=cap)
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
