"""Public wrappers for the kernels, in the model layout (the twins of
``repro.kernels.ops``).

Dispatch mirrors ``repro.kernels.ops._on_cpu``: a tensor on the CPU takes
the plain PyTorch version (``ref``); any other tensor goes to the CUDA
kernel, which launches or raises. There is no fallback from one to the
other. A tensor on the meta device (the dry-run, ``launch/dryrun.py``,
which counts FLOPs and bytes without computing) takes the plain version
too: meta computes nothing, so no kernel is hidden by it, and the counts
are the plain version's operations. No kernel has a backward (nor has any
kernel of the reference), so a CUDA branch raises ``ValueError`` when grad
mode is on and an input requires grad, instead of returning a result that
autograd cannot see through; training runs ``lm.forward(...,
use_kernels=False)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.causal_conv import causal_conv
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.kernels.similarity import topk_cosine
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.ssd_step import ssd_step


def _plain(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the plain version: on the CPU, or on the meta
    device. Every other device goes to the kernel."""
    return t.device.type in ("cpu", "meta")


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise ValueError(f"{name} kernel: an input requires grad and the kernel has no "
                         "backward (train through lm.forward(..., use_kernels=False))")


def flash_attention_op(q, k, v, *, causal: bool = True, logit_softcap: float = 0.0):
    """Model layout: q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    if _plain(q):
        o = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, logit_softcap=logit_softcap,
        )
        return o.transpose(1, 2)
    _refuse_grad("flash_attention", q, k, v)
    if logit_softcap:
        raise ValueError("flash_attention kernel: attn_logit_softcap is not supported")
    return flash_attention(q, k, v, causal=causal)


def _zero_empty_rows(o, lengths):
    """o (B, Hq, hd) with the rows of length 0 set to zeros, as the kernels
    return them (the plain oracle averages v over a fully masked row)."""
    lens = torch.as_tensor(lengths, device=o.device).reshape(-1).expand(o.shape[0])
    return o.masked_fill((lens <= 0)[:, None, None], 0.0)


def decode_attention_op(q, cache_k, cache_v, lengths, *, logit_softcap: float = 0.0):
    """q (B,1,Hq,hd); cache (B,M,Hkv,hd); lengths () or (B,) int32
    per-sequence valid counts -> (B,1,Hq,hd). A row of length 0 gives
    zeros."""
    if _plain(q):
        o = ref.decode_attention_ref(
            q[:, 0], cache_k.transpose(1, 2), cache_v.transpose(1, 2), lengths,
            logit_softcap=logit_softcap,
        )
        return _zero_empty_rows(o, lengths)[:, None]
    _refuse_grad("decode_attention", q, cache_k, cache_v)
    if logit_softcap:
        raise ValueError("decode_attention kernel: attn_logit_softcap is not supported")
    return decode_attention(q, cache_k, cache_v, torch.as_tensor(lengths, device=q.device))


def paged_decode_attention_op(q, k_pages, v_pages, page_table, lengths, *,
                              logit_softcap: float = 0.0):
    """Decode attention through a page table (the ``serving/kv_cache.py``
    pool). q (B,1,Hq,hd) model layout; k_pages/v_pages (N, page_size, Hkv,
    hd) pool slabs; page_table (B, P) int32 pool rows (-1 past the end);
    lengths (B,) valid tokens -> (B,1,Hq,hd). A row of length 0 gives
    zeros."""
    if _plain(q):
        o = ref.paged_attention_ref(q[:, 0], k_pages, v_pages, page_table, lengths,
                                    logit_softcap=logit_softcap)
        return _zero_empty_rows(o, lengths)[:, None]
    _refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    if logit_softcap:
        raise ValueError("paged_decode_attention kernel: attn_logit_softcap is not supported")
    return paged_decode_attention(q, k_pages, v_pages,
                                  torch.as_tensor(page_table, device=q.device),
                                  torch.as_tensor(lengths, device=q.device))


def wkv6_op(r, k, v, w_log, u, *, chunk: int = 64):
    """RWKV6 recurrence from a zero state, model layout: r, k, v, w_log
    (B, S, H, N), u (H, N) -> (y (B, S, H, N) float32, state (B, H, N, N)
    float32). On the CPU, the chunked plain version with chunk ``chunk``
    (the model passes its ``ssm.chunk_size``); the kernel has no chunk."""
    if _plain(r):
        return ref.wkv6_chunked_ref(r, k, v, w_log, u, chunk=chunk)
    _refuse_grad("wkv6", r, k, v, w_log, u)
    return wkv6(r, k, v, w_log, u)


def ssd_op(x, dt, A_log, B_, C_, D, *, chunk: int = 128):
    """Mamba-2 SSD scan from a zero state, model layout: x (B, S, H, P), dt
    (B, S, H), A_log and D (H,), B_/C_ (B, S, Ns), or (B, S, G, Ns) with
    head h reading group h // (H / G) -> (y (B, S, H, P) float32,
    state (B, H, P, Ns) float32). On the CPU, the chunked plain version
    with chunk ``chunk``; the kernel has no chunk."""
    if _plain(x):
        return ref.ssd_chunked_ref(x, dt, A_log, B_, C_, D, chunk=chunk)
    _refuse_grad("ssd", x, dt, A_log, B_, C_, D)
    return ssd(x, dt, A_log, B_, C_, D)


def ssd_step_op(x, dt, A_log, B_, C_, D, state):
    """One Mamba-2 decode step, model layout: x (B, H, P), dt (B, H), A_log
    and D (H,), B_/C_ (B, Ns) or (B, G, Ns), state (B, H, P, Ns) float32 ->
    (y (B, H, P) float32, state). On the CPU, ``models.mamba.ssd_step``,
    which returns a new state; the kernel updates ``state`` in place and
    returns it."""
    if _plain(x):
        from repro_torch.models.mamba import ssd_step as plain  # the models import ops

        return plain(x, dt, A_log, B_, C_, D, state)
    _refuse_grad("ssd_step", x, dt, A_log, B_, C_, D, state)
    return ssd_step(x, dt, A_log, B_, C_, D, state)


def causal_conv_op(xc, w, b, prev=None):
    """A Mamba-2 prefill's depthwise causal conv, its bias and SiLU: xc (B,
    S, CH), w (K, CH), b (CH,), prev (B, K-1, CH) carry or None (zeros) ->
    (y (B, S, CH) in xc's dtype, carry (B, K-1, CH)). On the CPU, the plain
    ``ref.causal_conv_ref``; the kernel takes K = 4 and CH a multiple of 8."""
    if _plain(xc):
        return ref.causal_conv_ref(xc, w, b, prev)
    _refuse_grad("causal_conv", xc, w, b, prev)
    return causal_conv(xc, w, b, prev)


def batch_topk(queries: torch.Tensor, bank, *, k: int = 1):
    """Batched fuzzy lookup: queries (Q, D) against bank (N, D), rows
    L2-normalized -> (scores (Q, k) float32, rows (Q, k) int32), one call
    for the whole request batch; (-1e30, -1) where fewer than k rows exist.

    A numpy bank is copied to the queries' device on every call (the
    ``pallas`` index backend's per-call upload); ``resident_topk`` is the
    variant for a bank that already lives there (``DeviceBank``)."""
    if not isinstance(bank, torch.Tensor):
        bank = torch.as_tensor(bank, dtype=torch.float32, device=queries.device)
    return resident_topk(queries, bank, k=k)


def resident_topk(queries: torch.Tensor, bank: torch.Tensor, *, k: int = 1):
    """Top-k against a bank tensor on the queries' device: the plain
    version for CPU tensors, the CUDA kernel for any other (it launches or
    raises; k > 32 raises)."""
    if queries.shape[0] == 0 or bank.shape[0] == 0:
        return (
            torch.full((queries.shape[0], k), ref.NEG_INF, dtype=torch.float32,
                       device=queries.device),
            torch.full((queries.shape[0], k), -1, dtype=torch.int32, device=queries.device),
        )
    if _plain(queries):
        if bank.device.type != queries.device.type:
            raise ValueError(f"resident_topk: queries on {queries.device}, bank on {bank.device}")
        return ref.topk_cosine_ref(queries, bank, k)
    _refuse_grad("topk_cosine", queries, bank)
    return topk_cosine(queries, bank, k)
