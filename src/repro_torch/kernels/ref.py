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


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        logit_softcap: float = 0.0):
    """q: (B, Hq, hd); k_pages, v_pages: (N, page_size, Hkv, hd) pool slabs;
    page_table: (B, P) pool rows (-1 past a sequence's last page); lengths:
    () or (B,) valid counts -> (B, Hq, hd). Gathers each sequence's pages in
    table order (entries below 0 clamped to row 0, as the kernel clamps them)
    into a dense cache, then runs ``decode_attention_ref``."""
    B, P = page_table.shape
    _, ps, Hkv, hd = k_pages.shape
    rows = page_table.to(device=k_pages.device, dtype=torch.long).clamp(min=0).reshape(-1)

    def dense(pages):  # -> (B, Hkv, P * ps, hd)
        g = pages.index_select(0, rows).reshape(B, P * ps, Hkv, hd)
        return g.transpose(1, 2)

    return decode_attention_ref(q, dense(k_pages), dense(v_pages), lengths,
                                logit_softcap=logit_softcap)


def topk_cosine_ref(queries: torch.Tensor, bank: torch.Tensor, k: int):
    """queries (Q, D), bank (N, D), rows L2-normalized -> (scores (Q, k) f32,
    indices (Q, k) int32): the k best ``q . bank[row]`` per query, in the
    order score descending, then row ascending. ``torch.topk`` documents no
    order among ties, so this sorts stably on the negated scores: among
    equal scores the lowest row comes first. Past N (N < k) the result is
    padded with (-1e30, -1); a score at or below -1e30 / 2 maps to row -1,
    as in the TPU kernel.

    Scores are the float64 dot products rounded to float32. A float32
    matmul may sum two identical rows in different orders depending on
    where they sit in the bank (the CPU's does), which breaks exact ties;
    the rounded float64 sum depends on the (query, row) values alone."""
    Q, N = queries.shape[0], bank.shape[0]
    dev = queries.device
    out_s = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    if Q == 0 or N == 0:
        return out_s, out_i
    scores = (queries.double() @ bank.double().T).float()  # (Q, N)
    kk = min(k, N)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :kk]
    top = torch.gather(scores, 1, order)
    out_s[:, :kk] = top
    out_i[:, :kk] = torch.where(top <= NEG_INF / 2, -1, order).to(torch.int32)
    return out_s, out_i
