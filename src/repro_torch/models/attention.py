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

Under a mesh (``ctx``, ``models/parallel.py``) each rank computes its
local heads (``tp_heads``) with the kernels at the local head counts, and
``wo``'s row shard ends in a ``psum`` over tp. The KV cache under a mesh is
the rank's block of the whole cache as ``cache_pspecs`` lays it out
(``kv_spec``: the (B, M, Hkv, hd) entries, batch local). Where that block
is exactly the kv heads the rank's queries read (heads split over tp, no
sequence sharding) the rank projects, stores and reads only those
(``kv_local``); otherwise it computes every kv head, stores its block of
them, and a decode step gathers the whole layer's cache over tp first.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import parallel as par
from repro_torch.models.common import Params, dense_init, dtype_of, rms_norm
from repro_torch.models.rope import apply_rope

ATTN_CHUNK = 2048  # the default of the config's attn_chunk


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


def _attend(q, k, v, causal: bool, cap: float, use_kernels: bool, chunk: int = ATTN_CHUNK):
    if use_kernels:
        return kops.flash_attention_op(q, k, v, causal=causal, logit_softcap=cap)
    if q.shape[1] > 512:
        return flash_attention_chunked(q, k, v, chunk=chunk, causal=causal, logit_softcap=cap)
    return naive_attention(q, k, v, causal=causal, logit_softcap=cap)


def attention_seq(cfg, p: Params, x: torch.Tensor, cos, sin, *, causal: bool = True,
                  use_kernels: bool = True, ctx=None, spec=None, kv_spec=None):
    """Full-sequence attention (prefill or training; ``causal=False`` for
    an encoder). ``use_kernels`` sends it to ``flash_attention_op``; else
    the reference's training path, ``naive_attention`` up to 512 positions
    and ``flash_attention_chunked`` past them. Returns (out, (k, v)).

    Under a mesh (``ctx``, with the layer's weight ``spec`` and the cache's
    ``kv_spec``) the rank attends over its local heads; (k, v) are then the
    local kv heads where ``kv_local`` holds, else every kv head."""
    B, S, _ = x.shape
    cap = cfg.attn_logit_softcap
    if not par.active(ctx):
        q, k, v = _project_qkv(cfg, p, x)
        q, k = _rope(q, k, cos, sin)
        o = _attend(q, k, v, causal, cap, use_kernels, cfg.attn_chunk)
        out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
        return out, (k, v)
    Q, K = tp_heads(cfg, ctx)
    local = kv_local(cfg, ctx, kv_spec)
    q, k, v = _project_tp(cfg, p, spec, x, ctx, Q, K, local)
    q, k = _rope(q, k, cos, sin)
    ka, va = (k, v) if local else (_select(ctx, k, K), _select(ctx, v, K))
    o = _attend(q, ka, va, causal, cap, use_kernels, cfg.attn_chunk)
    return par.row_out(ctx, o, p["wo"], spec["wo"], Q, cfg.num_heads, cfg.head_dim), (k, v)


def tp_heads(cfg, ctx):
    """(q heads, kv heads) this rank computes, as global head ids. The q
    heads are its tp share where they split evenly, else all; the kv heads
    are those its q heads read, in an order whose GQA grouping (q head j
    reads kv head j // (len(Q) / len(K))) holds: the distinct kv heads
    where that works, else one kv head per q head."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    lh = par.local_heads(ctx, H)
    Q = list(range(*lh)) if lh else list(range(H))
    g = H // Hkv
    K = sorted({h // g for h in Q})
    rep = len(Q) // len(K)
    if len(Q) % len(K) or any(K[j // rep] != h // g for j, h in enumerate(Q)):
        K = [h // g for h in Q]
    return Q, K


def kv_local(cfg, ctx, kv_spec) -> bool:
    """Whether the rank's cache block (``kv_spec``: (B, M, Hkv, hd)
    entries) holds exactly the kv heads its q heads read. Without a cache
    (training) the answer depends only on those heads."""
    Q, K = tp_heads(cfg, ctx)
    lh = par.local_heads(ctx, cfg.num_kv_heads)
    if lh is None or K != list(range(*lh)):
        return False
    if kv_spec is None:
        return True
    b, m, h, d = kv_spec
    return par.on_tp(ctx, h) and not shd.entry_axes(m) and not shd.entry_axes(d)


def _project_tp(cfg, p: Params, spec, x, ctx, Q, K, local: bool):
    """q (B, S, len(Q), hd) and k, v: the heads K where ``local``, else
    every kv head (pre-RoPE)."""
    hd = cfg.head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = par.heads(ctx, x, p["wq"], p.get("bq"), spec["wq"], Q, H, hd)
    want = K if local else list(range(Hkv))
    k = par.heads(ctx, x, p["wk"], p.get("bk"), spec["wk"], want, Hkv, hd)
    v = par.heads(ctx, x, p["wv"], p.get("bv"), spec["wv"], want, Hkv, hd)
    if cfg.qk_norm:  # the scales enter rank-specific heads: fan out their grads
        qs, ks = p["q_norm_scale"], p["k_norm_scale"]
        q = rms_norm(q, qs if Q == list(range(H)) else par.fan_out(ctx, qs))
        k = rms_norm(k, ks if want == list(range(Hkv)) else par.fan_out(ctx, ks))
    return q, k, v


def _select(ctx, x, heads):
    """The kv heads ``heads`` of every-kv-head ``x`` (B, S, Hkv, hd)."""
    if heads == list(range(x.shape[2])):
        return x
    return par.fan_out(ctx, x)[:, :, heads]


def attention_decode(
    cfg,
    p: Params,
    x: torch.Tensor,
    cos,
    sin,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos,
    lengths: torch.Tensor,
    ctx=None,
    spec=None,
    kv_spec=None,
) -> torch.Tensor:
    """Single-token decode. x: (B, 1, D); cache: (B, M, Hkv, hd) in x's
    dtype. Writes the new token's K/V IN PLACE at position ``pos`` (a (1,)
    int64 tensor on x's device; under a mesh an int) and attends over the
    first ``lengths[b]`` positions of row b ((B,) int32 on x's device;
    ``lm.decode_step`` passes ``pos + 1`` for every row). Returns out (B,
    1, D). Under a mesh the cache is the rank's block (module docstring).
    """
    B = x.shape[0]
    if par.active(ctx):
        return _decode_tp(cfg, p, x, cos, sin, cache_k, cache_v, pos, lengths, ctx, spec,
                          kv_spec)
    q, k, v = _project_qkv(cfg, p, x)  # (B, 1, H*, hd)
    q, k = _rope(q, k, cos, sin)
    cache_k.index_copy_(1, pos, k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos, v.to(cache_v.dtype))
    o = kops.decode_attention_op(q, cache_k, cache_v, lengths,
                                 logit_softcap=cfg.attn_logit_softcap)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def _decode_tp(cfg, p, x, cos, sin, cache_k, cache_v, pos, lengths, ctx, spec, kv_spec):
    """Decode on the rank's heads: its block of the cache directly where
    ``kv_local``, else the layer's whole cache gathered over tp, the new
    token written into it and into the rank's block."""
    Q, K = tp_heads(cfg, ctx)
    local = kv_local(cfg, ctx, kv_spec)
    q, k, v = _project_tp(cfg, p, spec, x, ctx, Q, K, local)
    q, k = _rope(q, k, cos, sin)
    cap = cfg.attn_logit_softcap
    if local:
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        o = kops.decode_attention_op(q, cache_k, cache_v, lengths, logit_softcap=cap)
    else:
        full = []
        for cache, new in ((cache_k, k), (cache_v, v)):
            whole = shd.gather_leaf(cache, kv_spec, ctx.mesh)
            whole[:, pos] = new[:, 0].to(whole.dtype)
            par.write_block(ctx, cache, new.to(cache.dtype), (0, pos, 0, 0), kv_spec)
            full.append(whole[:, :, K].contiguous())
        o = kops.decode_attention_op(q, full[0], full[1], lengths, logit_softcap=cap)
    return par.row_out(ctx, o, p["wo"], spec["wo"], Q, cfg.num_heads, cfg.head_dim)


def attention_extend(cfg, p: Params, x: torch.Tensor, cos, sin,
                     prefix_k: torch.Tensor, prefix_v: torch.Tensor, prefix_len: int, *,
                     ctx=None, spec=None, kv_spec=None, prefix_spec=None):
    """Chunked-prefill continuation: the suffix attends over a prefilled
    prefix plus itself causally.

    x: (B, S, D) suffix activations; prefix_k/v: (B, Sp, Hkv, hd) cached
    post-RoPE prefix K/V (Sp >= prefix_len; positions past ``prefix_len``
    are page padding and are masked out). cos/sin are taken at positions
    offset by ``prefix_len``. Scores and softmax in fp32.
    Returns (out (B, S, D), (k_suf, v_suf)).

    Under a mesh (``ctx``, the weight ``spec``, the cache's ``kv_spec``) the
    rank attends over its local heads; prefix_k/v are the rank's block of
    the pooled prefix under ``prefix_spec`` (``parallel.prefix_spec``), read
    directly where it holds exactly the rank's kv heads and gathered over
    tp otherwise; (k_suf, v_suf) are as ``attention_seq`` gives them for
    ``kv_spec``.
    """
    if not par.active(ctx):
        q, k, v = _project_qkv(cfg, p, x)
        q, k = _rope(q, k, cos, sin)
        o = _extend_core(cfg, q, prefix_k, prefix_v, k, v, prefix_len)
        return o.reshape(*o.shape[:2], cfg.q_dim).to(q.dtype) @ p["wo"], (k, v)
    Q, K = tp_heads(cfg, ctx)
    local = kv_local(cfg, ctx, kv_spec)
    q, k, v = _project_tp(cfg, p, spec, x, ctx, Q, K, local)
    q, k = _rope(q, k, cos, sin)
    ka, va = (k, v) if local else (_select(ctx, k, K), _select(ctx, v, K))
    if kv_local(cfg, ctx, prefix_spec):
        pk, pv = prefix_k, prefix_v
    else:
        pk, pv = (shd.gather_leaf(t, prefix_spec, ctx.mesh)[:, :, K] for t in (prefix_k, prefix_v))
    o = _extend_core(cfg, q, pk, pv, ka, va, prefix_len).to(q.dtype)
    return par.row_out(ctx, o, p["wo"], spec["wo"], Q, cfg.num_heads, cfg.head_dim), (k, v)


def _extend_core(cfg, q, prefix_k, prefix_v, k, v, prefix_len: int):
    """q (B, S, Hq, hd) over the prefix (B, Sp, Hkv, hd), the first
    ``prefix_len`` positions visible, then the suffix k/v causally; GQA by
    groups of Hq / Hkv. Returns (B, S, Hq, hd) fp32."""
    B, S, Hq, hd = q.shape
    Sp = prefix_k.shape[1]
    keys = torch.cat([prefix_k.to(q.dtype), k], dim=1)
    vals = torch.cat([prefix_v.to(q.dtype), v], dim=1)
    M = Sp + S
    Hkv = keys.shape[2]
    G = Hq // Hkv
    # per-query mask: prefix keys below prefix_len are always visible;
    # suffix keys are causal relative to the suffix row
    row = torch.arange(S, device=q.device)[:, None]
    col = torch.arange(M, device=q.device)[None, :]
    visible = torch.where(col < Sp, col < prefix_len, (col - Sp) <= row)
    qg = q.reshape(B, S, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys.float()) / math.sqrt(hd)
    cap = cfg.attn_logit_softcap
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    s = s.masked_fill(~visible, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr, vals.float())
    return o.reshape(B, S, Hq, hd)


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


def cross_attention_kv(cfg, p: Params, enc_out: torch.Tensor, *, ctx=None, spec=None,
                       kv_spec=None):
    """Cross K/V from the encoder output (once per request): (B, T, Hkv, hd)
    each; under a mesh the rank's kv heads where ``kv_local`` holds for the
    cross cache's ``kv_spec``, else every kv head."""
    B, T, _ = enc_out.shape
    if par.active(ctx):
        Q, K = tp_heads(cfg, ctx)
        want = K if kv_local(cfg, ctx, kv_spec) else list(range(cfg.num_kv_heads))
        return tuple(par.heads(ctx, enc_out, p[w], None, spec[w], want, cfg.num_kv_heads,
                               cfg.head_dim) for w in ("wk", "wv"))
    k = (enc_out @ p["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def cross_attention(cfg, p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
                    ctx=None, spec=None, kv_spec=None, block: bool = False):
    """x (B, S, D) attends over every encoder position of ck/cv (B, T, Hkv,
    hd): the reference's ``naive_attention(causal=False)``, scores and
    softmax in fp32. Returns (B, S, D). Under a mesh, on the rank's heads;
    ``block`` says ck/cv are the rank's block of the cross cache (decode),
    gathered over tp first unless ``kv_local`` holds."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    if par.active(ctx):
        Q, K = tp_heads(cfg, ctx)
        q = par.heads(ctx, x, p["wq"], None, spec["wq"], Q, cfg.num_heads, hd)
        if not kv_local(cfg, ctx, kv_spec):
            if block:
                ck, cv = (shd.gather_leaf(c, kv_spec, ctx.mesh) for c in (ck, cv))
            ck, cv = _select(ctx, ck, K), _select(ctx, cv, K)
        o = _cross_core(q, ck, cv, hd)
        return par.row_out(ctx, o.to(x.dtype), p["wo"], spec["wo"], Q, cfg.num_heads, hd)
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    return _cross_core(q, ck, cv, hd).reshape(B, S, cfg.q_dim).to(x.dtype) @ p["wo"]


def _cross_core(q, ck, cv, hd):
    """Bidirectional fp32 attention of q (B, S, Hq, hd) over ck/cv (B, T,
    Hkv, hd), GQA by groups: (B, S, Hq, hd) fp32."""
    B, S, Hq, _ = q.shape
    Hkv = ck.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) / math.sqrt(hd)
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), cv.float())
    return o.reshape(B, S, Hq, hd)
