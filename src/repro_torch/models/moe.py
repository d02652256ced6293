"""Mixture-of-Experts layers (the port of ``repro.models.moe``).

Two execution paths, one parameterization:

  * ``moe_forward_grouped`` — exact dropless top-k MoE: the (token, expert)
    pairs sorted by expert, each expert's rows through its FFN. The
    reference runs ``jax.lax.ragged_dot`` (an XLA op, not a Pallas kernel);
    here a loop of ``torch.matmul`` over the experts that received rows.
    It reads the group sizes on the host (one device sync a call); on the
    meta device, which has no values to read (the dry-run), the pairs run
    as an even load over the experts, which gives the same products' work.
  * ``moe_forward_dense`` — GShard-style capacity-factor dispatch with
    one-hot einsums; a (token, k) pair past its expert's capacity is
    dropped, exactly as the reference drops it.

  * ``moe_forward_ep`` — expert parallelism over a mesh (the reference's
    shard_map + all_to_all): each rank routes its tokens, buckets the
    (token, expert) pairs by expert with a per-expert capacity, sends each
    expert's bucket to the rank that holds it (a tiled ``all_to_all`` over
    the ep axis, the payload in ``a2a_dtype``), runs its local experts as
    one batched product, and sends the rows back for the weighted combine.

``moe_forward`` takes ``mode="ep"`` to the EP path under a mesh and to the
grouped path without one, as the reference does. Every path returns ``(y,
aux_loss)``, aux_loss the load-balancing loss E * sum_e(f_e * p_e) *
aux_loss_weight.

Expert weights are (E, D, F) / (E, F, D) in ``param_dtype``; the router is
(D, E) in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh_compat as mc
from repro_torch.models import parallel as par
from repro_torch.models.common import Params, dense_init, dtype_of, mlp_act_fn


def _experts_init(generator, shape, dtype, device) -> torch.Tensor:
    """An (E, ...) expert tensor drawn one expert at a time, so the fp32
    draw is one expert's transient, not the whole tensor's (kimi-k2's
    (384, 7168, 2048) would be 22.5 GB in fp32). On the meta device
    (``lm.abstract_params``) the shape alone."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.device.type == "meta":
        return w
    for e in range(shape[0]):
        w[e] = dense_init(generator, shape[1:], dtype, device)
    return w


def moe_init(cfg, generator, device) -> Params:
    e = cfg.moe
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p: Params = {
        "router": dense_init(generator, (d, e.num_experts), torch.float32, device),
    }
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = _experts_init(generator, (e.num_experts, d, e.d_ff_expert), dt, device)
    p["w_up"] = _experts_init(generator, (e.num_experts, d, e.d_ff_expert), dt, device)
    p["w_down"] = _experts_init(generator, (e.num_experts, e.d_ff_expert, d), dt, device)
    return p


def _routing(cfg, p: Params, x2d: torch.Tensor, ctx=None):
    """x2d: (T, D) -> (probs (T, E) f32, topk_w (T, K) f32, topk_idx (T, K)
    int64, aux). Ties in the top-k go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
    makes no such promise). Under a mesh (``ctx``) whose dp ranks hold
    other tokens, the aux loss is over all of them (the routed counts and
    the probabilities summed over dp), as the reference's global batch."""
    e = cfg.moe
    logits = x2d.float() @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = topk_w[:, :e.experts_per_token], topk_idx[:, :e.experts_per_token]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss
    T = x2d.shape[0]
    idx = topk_idx.reshape(-1)  # counted by index_add: exact, and it runs on meta too
    routed = torch.zeros(e.num_experts, dtype=torch.float32, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    if par.active(ctx) and ctx.dp:
        n = ctx.mesh.axis_size(ctx.dp)
        routed = mc.psum(routed, ctx.mesh, ctx.dp)
        f = routed / (T * n * e.experts_per_token)
        pbar = mc.psum(probs.sum(dim=0), ctx.mesh, ctx.dp) / (T * n)
    else:
        f = routed / (T * e.experts_per_token)  # fraction routed
        pbar = probs.mean(dim=0)
    aux = e.num_experts * torch.sum(f * pbar) * e.aux_loss_weight
    return probs, topk_w, topk_idx, aux


def _ffn(cfg, h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """One expert's FFN (or, with a leading expert axis on every operand, a
    batch of them) on rows h (..., D)."""
    if cfg.mlp_act == "swiglu":
        a = F.silu(h @ w_gate) * (h @ w_up)
    else:
        a = mlp_act_fn(cfg.mlp_act)(h @ w_up)
    return a @ w_down


def _expert_ffn(cfg, p: Params, h: torch.Tensor, group_sizes) -> torch.Tensor:
    """Grouped FFN: h (M, D) sorted by expert, ``group_sizes`` (E,) host ints
    -> (M, D); an expert with no rows runs nothing."""
    outs = [_ffn(cfg, rows, p["w_gate"][e] if "w_gate" in p else None, p["w_up"][e],
                 p["w_down"][e])
            for e, rows in enumerate(torch.split(h, group_sizes)) if rows.shape[0]]
    return torch.cat(outs)


def _even_ffn(cfg, p: Params, h: torch.Tensor) -> torch.Tensor:
    """The grouped FFN on meta rows h (M, D): ceil(M / E) rows an expert as
    one batched product (no host read of the group sizes), trimmed to M."""
    E = p["w_up"].shape[0]
    M, D = h.shape
    r = -(-M // E)
    hp = torch.cat([h, h.new_zeros((E * r - M, D))]).reshape(E, r, D)
    return _ffn(cfg, hp, p.get("w_gate"), p["w_up"], p["w_down"]).reshape(E * r, D)[:M]


def moe_forward_grouped(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless: every routed (token, expert) pair is computed."""
    e = cfg.moe
    B, S, D = x.shape
    T, K = B * S, e.experts_per_token
    x2d = x.reshape(T, D)
    _, topk_w, topk_idx, aux = _routing(cfg, p, x2d)
    flat_expert = topk_idx.reshape(-1)  # (T*K,)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = flat_token[order]
    if x.device.type == "meta":
        out_sorted = _even_ffn(cfg, p, x2d[sorted_tokens])
    else:
        group_sizes = torch.bincount(flat_expert, minlength=e.num_experts).tolist()
        out_sorted = _expert_ffn(cfg, p, x2d[sorted_tokens], group_sizes)  # (T*K, D)
    w_sorted = topk_w.reshape(-1)[order]
    contrib = out_sorted * w_sorted[:, None].to(out_sorted.dtype)
    y2d = torch.zeros((T, D), dtype=contrib.dtype, device=x.device)
    y2d.index_add_(0, sorted_tokens, contrib)
    return y2d.reshape(B, S, D).to(x.dtype), aux


def gshard_capacity(cfg, tokens_per_group: int) -> int:
    """The reference's per-expert capacity of one dispatch group."""
    e = cfg.moe
    return int(tokens_per_group * e.experts_per_token / e.num_experts * e.capacity_factor) + 1


def gshard_positions(topk_idx: torch.Tensor, num_experts: int, capacity: int):
    """topk_idx (G, Tg, K) -> (pos, keep), each (G, Tg, K): the place of each
    (token, k) pair in its expert's queue of the group, in (token, k)
    order, and whether it is within ``capacity`` (a pair past it is
    dropped)."""
    G, Tg, K = topk_idx.shape
    flat = F.one_hot(topk_idx, num_experts).reshape(G, Tg * K, num_experts)
    pos = torch.cumsum(flat, dim=1) - flat  # (G, Tg*K, E) place in queue
    pos = (pos * flat).sum(dim=-1).reshape(G, Tg, K)
    return pos, pos < capacity


def moe_forward_dense(cfg, p: Params, x: torch.Tensor, *, capacity: Optional[int] = None,
                      ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch: one group per batch row; each expert takes at most
    ``capacity`` (default ``gshard_capacity``) of the group's pairs. Under
    a mesh every rank holds every expert and dispatches its own rows."""
    e = cfg.moe
    B, S, D = x.shape
    G, Tg, K, E = B, S, e.experts_per_token, e.num_experts
    _, topk_w, topk_idx, aux = _routing(cfg, p, x.reshape(G * Tg, D), ctx)
    topk_w, topk_idx = topk_w.reshape(G, Tg, K), topk_idx.reshape(G, Tg, K)
    C = gshard_capacity(cfg, Tg) if capacity is None else capacity
    pos, keep = gshard_positions(topk_idx, E, C)
    onehot = F.one_hot(topk_idx, E).float()  # (G, Tg, K, E)
    pos_oh = F.one_hot(torch.where(keep, pos, C), C + 1).float()[..., :C]  # (G, Tg, K, C)
    disp = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, topk_w)
    xe = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), x)  # (G, E, C, D)
    ye = _ffn(cfg, xe, p["w_gate"][None] if "w_gate" in p else None, p["w_up"][None],
              p["w_down"][None])  # (G, E, C, D)
    y = torch.einsum("gtec,gecd->gtd", comb.to(ye.dtype), ye)
    return y.to(x.dtype), aux


_WIRE = {"auto": None, "bfloat16": torch.bfloat16, "float32": torch.float32,
         "float8_e4m3fn": torch.float8_e4m3fn}


def moe_forward_ep(cfg, p: Params, x: torch.Tensor, *, mesh, ep_axis: str = "model",
                   dp_axes: Tuple[str, ...] = ("data",), capacity: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Experts sharded over ``ep_axis`` (``p``: the rank's (e_loc, D, F)
    experts, the router whole); ``x``: the rank's tokens (B, S, D).

    Each rank routes its tokens and buckets the (token, k) pairs by expert:
    expert e takes ``capacity`` (default ``int(T * K / E *
    capacity_factor) + 1``, T the rank's tokens of a dispatch chunk) rows,
    a pair's place among its expert's pairs its rank in a stable sort by
    expert; pairs past the capacity go to the dropped slot ``E * cap`` and
    contribute nothing. The buckets cross the ep axis by a tiled
    ``all_to_all``, the local experts run as one batched product, and the
    rows come back the same way for the weighted combine. The payload
    crosses in ``a2a_dtype``; float8_e4m3fn carries a per-row scale
    (``max|x| / 240``, floored at 1e-6 before the division). The aux loss
    is ``pmean``'d over ep and the dp axes; with ``dispatch_chunks`` the
    last chunk's is returned, as the reference does. ``moe_forward_ep.dropped``
    counts the rank's dropped pairs since it was last set to 0 (a 0-d tensor
    on the device, read without a sync per call)."""
    e = cfg.moe
    B, S, D = x.shape
    n_ep = mesh.axis_size(ep_axis) if ep_axis in mesh.axis_names else 1
    E, K = e.num_experts, e.experts_per_token
    if E % n_ep:
        raise ValueError(f"{E} experts do not split over {n_ep} ep ranks")
    e_loc = E // n_ep
    if p["w_up"].shape[0] != e_loc:
        raise ValueError(f"expected the rank's {e_loc} experts, got {p['w_up'].shape[0]}")
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    # the tokens are the same on every ep rank unless ep is a dp axis: the
    # router and x then enter a rank-specific dispatch (fan out their
    # grads), and each rank's copy of the result takes 1/n_ep of its grad
    same = ep_axis in mesh.axis_names and ep_axis not in dp
    router = mc.fan_out(p["router"], mesh, ep_axis) if same else p["router"]
    if same:
        x = mc.fan_out(x, mesh, ep_axis)
    wire = _WIRE[e.a2a_dtype]
    T_all = B * S
    x2d_all = x.reshape(T_all, D)
    n_chunks = max(1, e.dispatch_chunks)
    if T_all % n_chunks:
        raise ValueError(f"{T_all} tokens do not split into {n_chunks} dispatch chunks")
    Tc = T_all // n_chunks
    ys, aux = [], None
    for ci in range(n_chunks):
        y, aux = _dispatch_block(cfg, p, router, x2d_all[ci * Tc:(ci + 1) * Tc], mesh,
                                 ep_axis, dp, n_ep, e_loc, wire, capacity)
        ys.append(y)
    y2d = torch.cat(ys) if n_chunks > 1 else ys[0]
    y = y2d.reshape(B, S, D).to(x.dtype)
    return (par.share_grad(y, n_ep) if same else y), aux


moe_forward_ep.dropped = 0  # (token, expert) pairs dropped since the last reset


def _quant(rows: torch.Tensor, wire):
    """(payload in the wire dtype, per-row fp32 scale or None)."""
    if wire is not torch.float8_e4m3fn:
        return rows.to(wire), None
    scale = torch.amax(torch.abs(rows.float()), dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-6) / 240.0
    return (rows / scale).to(wire), scale[:, 0]


def _dequant(rows: torch.Tensor, scale, dtype):
    if scale is None:
        return rows.to(dtype)
    return (rows.float() * scale[:, None]).to(dtype)


def _dispatch_block(cfg, p, router, x2d, mesh, ep_axis, dp, n_ep, e_loc, wire, capacity):
    e = cfg.moe
    T, D = x2d.shape
    E, K = e.num_experts, e.experts_per_token
    _, topk_w, topk_idx, aux = _routing(cfg, {"router": router}, x2d)
    if ep_axis in mesh.axis_names:
        aux = mc.pmean(aux, mesh, ep_axis)
    for ax in dp:
        aux = mc.pmean(aux, mesh, ax)
    cap = int(T * K / E * e.capacity_factor) + 1 if capacity is None else capacity
    flat_e = topk_idx.reshape(-1)  # (T*K,) global expert ids
    flat_t = torch.arange(T, device=x2d.device).repeat_interleave(K)
    flat_w = topk_w.reshape(-1)
    # the place of each pair among its expert's pairs, by stable sort rank
    M0 = T * K
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty(M0, dtype=torch.int64, device=x2d.device)
    pos[order] = torch.arange(M0, device=x2d.device) - first
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, E * cap))
    moe_forward_ep.dropped = moe_forward_ep.dropped + (~keep).sum()  # on the device

    dt_wire = wire if wire is not None else x2d.dtype
    payload, pscale = _quant(x2d[flat_t], dt_wire)
    send = torch.zeros((E * cap + 1, D), dtype=dt_wire, device=x2d.device)
    send = send.index_put((slot,), payload)
    send = send[:E * cap].reshape(n_ep, e_loc * cap, D)
    recv = mc.all_to_all(send, mesh, ep_axis)  # (n_ep src, e_loc*cap, D)
    if pscale is not None:
        sscale = torch.zeros(E * cap + 1, dtype=torch.float32, device=x2d.device)
        sscale = sscale.index_put((slot,), pscale)[:E * cap].reshape(n_ep, e_loc * cap)
        rscale = mc.all_to_all(sscale, mesh, ep_axis)
        recv = _dequant(recv.reshape(-1, D), rscale.reshape(-1), x2d.dtype)
    xe = recv.to(x2d.dtype).reshape(n_ep, e_loc, cap, D).transpose(0, 1)
    xe = xe.reshape(e_loc, n_ep * cap, D)
    ye = _ffn(cfg, xe, p.get("w_gate"), p["w_up"], p["w_down"])  # (e_loc, n_ep*cap, D)

    yq, yscale = _quant(ye.reshape(-1, D), dt_wire)
    back = yq.reshape(e_loc, n_ep, cap, D).transpose(0, 1).reshape(n_ep, e_loc * cap, D)
    back = mc.all_to_all(back.contiguous(), mesh, ep_axis)
    if yscale is not None:
        bscale = yscale.reshape(e_loc, n_ep, cap).transpose(0, 1).reshape(n_ep, e_loc * cap)
        bscale = mc.all_to_all(bscale.contiguous(), mesh, ep_axis)
        back_rows = _dequant(back.reshape(E * cap, D), bscale.reshape(-1), x2d.dtype)
    else:
        back_rows = back.reshape(E * cap, D).to(x2d.dtype)
    back2d = torch.cat([back_rows, back_rows.new_zeros((1, D))])
    contrib = back2d[slot] * flat_w[:, None].to(x2d.dtype)  # dropped slots read zeros
    y2d = torch.zeros((T, D), dtype=contrib.dtype, device=x2d.device)
    return y2d.index_add(0, flat_t, contrib), aux


def moe_forward(cfg, p: Params, x: torch.Tensor,
                ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe.mode`` and the mesh: "ep" with a mesh in
    ``ctx`` runs ``moe_forward_ep`` (``p`` the rank's experts); "ep"
    without one the grouped path, as the reference does; "dense" GShard
    dispatch (under a mesh, on the rank's rows with every expert)."""
    mode = cfg.moe.mode
    if mode == "ep" and par.active(ctx):
        return moe_forward_ep(cfg, p, x, mesh=ctx.mesh, ep_axis=ctx.ep_axis,
                              dp_axes=ctx.dp_axes)
    if mode == "ep":
        return moe_forward_grouped(cfg, p, x)
    if mode == "dense":
        return moe_forward_dense(cfg, p, x, ctx=ctx if par.active(ctx) else None)
    raise ValueError(f"moe mode {mode!r}; the port has 'dense' and 'ep'")
