"""Plain PyTorch versions of the ported kernels (twins of the oracles in
``repro.kernels.ref``), in the kernels' layout, with an fp32 softmax.

Deliberately naive: they materialize the scores. They are what the kernel
wrappers run for a tensor on the CPU, and what each CUDA kernel is held
against on the card.

The two recurrences have two plain versions each, in the model layout
(B, S, H, ·): the chunked forms (``wkv6_chunked_ref``, ``ssd_chunked_ref``,
the twins of ``repro.models.rwkv.wkv6_chunked`` and
``repro.models.mamba.ssd_chunked``), which the wrappers run, and the
sequential oracles (``rwkv6_ref``, ``ssd_ref``, the twins of
``repro.kernels.ref``'s), which the tests hold everything to. The chunked
forms keep the reference's factorisation, overflow included: they multiply
``k * exp(-la)`` and take ``exp(la_i - la_j)`` before the causal mask, so a
chunk whose cumulative log decay ``|la|`` passes ~88 gives inf * 0 = NaN
where the recurrence stays finite.
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


def decode_attention_split_ref(q, k, v, length, chunk: int = 32):
    """``decode_attention_ref`` as the split-K CUDA kernel computes it. The
    positions are cut into chunks of ``chunk`` from position 0; per chunk
    below the row's length, its max score m_c, l_c = sum exp(s - m_c) and
    acc_c = sum exp(s - m_c) v over its positions below the length; then
    m = max m_c, and L and O sum l_c and acc_c scaled by exp(m_c - m) over
    those chunks in chunk order; out = O / max(L, 1e-30). A row of length 0
    gives zeros, as the TPU and CUDA kernels do (``decode_attention_ref``
    averages v there). q: (B, Hq, hd); k, v: (B, Hkv, M, hd); length: () or
    (B,) -> (B, Hq, hd) in q's dtype."""
    B, Hq, hd = q.shape
    Hkv, M = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nc = -(-M // chunk)
    Mp = nc * chunk
    lens = torch.as_tensor(length, dtype=torch.int32, device=q.device).reshape(-1)
    lens = lens.expand(B).clamp(0, M)
    kr = _pad_seq(k.repeat_interleave(G, dim=1).float().transpose(1, 2), Mp - M)
    vr = _pad_seq(v.repeat_interleave(G, dim=1).float().transpose(1, 2), Mp - M)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr) / math.sqrt(hd)  # (B, Hq, Mp)
    valid = torch.arange(Mp, device=q.device)[None, :] < lens[:, None]  # (B, Mp)
    s = s.masked_fill(~valid[:, None, :], NEG_INF).reshape(B, Hq, nc, chunk)
    m_c = s.amax(-1)  # (B, Hq, nc)
    p = torch.exp(s - m_c[..., None]) * valid.reshape(B, 1, nc, chunk)
    l_c = p.sum(-1)
    acc_c = torch.einsum("bhcj,bcjhd->bhcd", p, vr.reshape(B, nc, chunk, Hq, hd))
    live = (torch.arange(nc, device=q.device) * chunk)[None, :] < lens[:, None]  # (B, nc)
    m = m_c.masked_fill(~live[:, None, :], NEG_INF).amax(-1)  # (B, Hq)
    L = torch.zeros((B, Hq), dtype=torch.float32, device=q.device)
    O = torch.zeros((B, Hq, hd), dtype=torch.float32, device=q.device)
    for c in range(nc):
        w = torch.exp(m_c[..., c] - m) * live[:, None, c]
        L = L + l_c[..., c] * w
        O = O + acc_c[..., c, :] * w[..., None]
    return (O / L.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        logit_softcap: float = 0.0, chunk: int | None = None):
    """q: (B, Hq, hd); k_pages, v_pages: (N, page_size, Hkv, hd) pool slabs;
    page_table: (B, P) pool rows (-1 past a sequence's last page); lengths:
    () or (B,) valid counts -> (B, Hq, hd). Gathers each sequence's pages in
    table order (entries below 0 clamped to row 0, as the kernel clamps them)
    into a dense cache, then runs ``decode_attention_ref``, or with
    ``chunk`` (no softcap) ``decode_attention_split_ref``."""
    B, P = page_table.shape
    _, ps, Hkv, hd = k_pages.shape
    rows = page_table.to(device=k_pages.device, dtype=torch.long).clamp(min=0).reshape(-1)

    def dense(pages):  # -> (B, Hkv, P * ps, hd)
        g = pages.index_select(0, rows).reshape(B, P * ps, Hkv, hd)
        return g.transpose(1, 2)

    if chunk is not None:
        if logit_softcap:
            raise ValueError("paged_attention_ref: the split form takes no softcap")
        return decode_attention_split_ref(q, dense(k_pages), dense(v_pages), lengths,
                                          chunk=chunk)
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


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) by ``pad`` positions."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)


def wkv6_chunked_ref(r, k, v, w_log, u, state0=None, *, chunk: int = 64):
    """RWKV6 recurrence, chunked. r, k, v, w_log: (B, S, H, N); u: (H, N);
    state0: (B, H, N, N) or None (zeros) -> (y (B, S, H, N) fp32, state
    (B, H, N, N) fp32). A ragged tail is zero-padded (zero decay, zero
    inputs)."""
    B, S, H, N = r.shape
    C = min(chunk, S)
    pad = (-S) % C
    rc, kc, vc, wc = (_pad_seq(t.float(), pad) for t in (r, k, v, w_log))
    uf = u.float()
    tri_excl = (torch.arange(C, device=r.device)[None, :]
                < torch.arange(C, device=r.device)[:, None]).float()
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    ys = []
    for c0 in range(0, S + pad, C):
        rb, kb, vb, wb = (t[:, c0:c0 + C] for t in (rc, kc, vc, wc))  # (B, C, H, N)
        la = torch.cumsum(wb, dim=1)  # inclusive cumulative log decay
        la_prev = la - wb
        la_end = la[:, -1:]
        q_t = rb * torch.exp(la_prev)
        k_t = kb * torch.exp(-la)
        scores = torch.einsum("bihn,bjhn->bhij", q_t, k_t) * tri_excl
        y_intra = torch.einsum("bhij,bjhn->bihn", scores, vb)
        y_diag = (rb * uf * kb).sum(-1, keepdim=True) * vb
        y_inter = torch.einsum("bihn,bhnm->bihm", q_t, state)
        ys.append(y_intra + y_diag + y_inter)
        k_dec = kb * torch.exp(la_end - la)
        state = torch.exp(la_end[:, 0])[..., None] * state + torch.einsum(
            "bjhn,bjhm->bhnm", k_dec, vb)
    return torch.cat(ys, dim=1)[:, :S], state


def rwkv6_ref(r, k, v, w_log, u, state0=None):
    """Sequential wkv6 (the oracle). r, k, v, w_log: (B, S, H, N); u: (H, N);
    state0: (B, H, N, N) or None (zeros) -> (y (B, S, H, N), state), fp32."""
    B, S, H, N = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w_log))
    uf = u.float()
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    ys = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # (B, H, N)
        y = torch.einsum("bhn,bhnm->bhm", rt, state)
        y = y + (rt * uf * kt).sum(-1, keepdim=True) * vt
        state = torch.exp(wt)[..., None] * state + kt[..., None] * vt[..., None, :]
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros((B, 0, H, N))
    return y, state


def _by_group(scan, x, dt, A_log, B_, C_, D, state0, **kw):
    """``scan`` over B_/C_ of (B, S, G, Ns): group g's heads [g H/G, (g+1)
    H/G) run with its B_ and C_, and their y and states are joined."""
    H, G = x.shape[2], B_.shape[2]
    if H % G:
        raise ValueError(f"ssd: {G} B/C groups do not divide {H} heads")
    n = H // G
    outs = [scan(x[:, :, g * n:(g + 1) * n], dt[..., g * n:(g + 1) * n],
                 A_log[g * n:(g + 1) * n], B_[:, :, g], C_[:, :, g], D[g * n:(g + 1) * n],
                 None if state0 is None else state0[:, g * n:(g + 1) * n], **kw)
            for g in range(G)]
    return torch.cat([y for y, _ in outs], dim=2), torch.cat([s for _, s in outs], dim=1)


def ssd_chunked_ref(x, dt, A_log, B_, C_, D, state0=None, *, chunk: int = 128):
    """Mamba-2 SSD scan, chunked. x: (B, S, H, P); dt: (B, S, H); A_log, D:
    (H,); B_, C_: (B, S, Ns) shared across heads, or (B, S, G, Ns), head h
    reading group h // (H / G); state0: (B, H, P, Ns) or None (zeros) ->
    (y (B, S, H, P) fp32, state (B, H, P, Ns) fp32). A ragged tail is
    zero-padded."""
    if B_.dim() == 4:
        return _by_group(ssd_chunked_ref, x, dt, A_log, B_, C_, D, state0, chunk=chunk)
    Bb, S, H, P = x.shape
    Ns = B_.shape[-1]
    Cs = min(chunk, S)
    pad = (-S) % Cs
    xc, dtc, Bc, Cc = (_pad_seq(t.float(), pad) for t in (x, dt, B_, C_))
    neg_A = -torch.exp(A_log.float())
    Df = D.float()
    tri_incl = (torch.arange(Cs, device=x.device)[None, :]
                <= torch.arange(Cs, device=x.device)[:, None]).float()
    state = (torch.zeros((Bb, H, P, Ns), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    ys = []
    for c0 in range(0, S + pad, Cs):
        xb, dtb, Bb_, Cb = (t[:, c0:c0 + Cs] for t in (xc, dtc, Bc, Cc))
        la = torch.cumsum(dtb * neg_A, dim=1)  # (B, C, H) inclusive
        la_end = la[:, -1:]
        dec = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # (B, Ci, Cj, H)
        cb = torch.einsum("bis,bjs->bij", Cb, Bb_)
        scores = cb[..., None] * dec * tri_incl[None, :, :, None]
        dtx = xb * dtb[..., None]
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, dtx)
        y_inter = torch.exp(la)[..., None] * torch.einsum("bhps,bis->bihp", state, Cb)
        ys.append(y_intra + y_inter + Df[:, None] * xb)
        k_dec = dtx * torch.exp(la_end - la)[..., None]
        state = torch.exp(la_end[:, 0])[..., None, None] * state + torch.einsum(
            "bjhp,bjs->bhps", k_dec, Bb_)
    return torch.cat(ys, dim=1)[:, :S], state


def ssd_ref(x, dt, A_log, B_, C_, D, state0=None):
    """Sequential SSD (the oracle). x: (B, S, H, P); dt: (B, S, H); B_, C_:
    (B, S, Ns), or (B, S, G, Ns) by group as ``ssd_chunked_ref``; A_log, D:
    (H,); state0: (B, H, P, Ns) or None (zeros) -> (y (B, S, H, P), state),
    fp32."""
    if B_.dim() == 4:
        return _by_group(ssd_ref, x, dt, A_log, B_, C_, D, state0)
    Bb, S, H, P = x.shape
    Ns = B_.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B_, C_))
    neg_A = -torch.exp(A_log.float())
    Df = D.float()
    state = (torch.zeros((Bb, H, P, Ns), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    ys = []
    for t in range(S):
        xt, dtt = xf[:, t], dtf[:, t]  # (B, H, P), (B, H)
        a = torch.exp(dtt * neg_A)
        dtx = xt * dtt[..., None]
        state = a[..., None, None] * state + dtx[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bhps,bs->bhp", state, Cf[:, t]) + Df[:, None] * xt)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bb, 0, H, P))
    return y, state
