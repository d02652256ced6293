"""Mixture-of-Experts layers (the port of ``repro.models.moe``).

Two execution paths, one parameterization:

  * ``moe_forward_grouped`` — exact dropless top-k MoE: the (token, expert)
    pairs sorted by expert, each expert's rows through its FFN. The
    reference runs ``jax.lax.ragged_dot`` (an XLA op, not a Pallas kernel);
    here a loop of ``torch.matmul`` over the experts that received rows.
    It reads the group sizes on the host (one device sync a call).
  * ``moe_forward_dense`` — GShard-style capacity-factor dispatch with
    one-hot einsums; a (token, k) pair past its expert's capacity is
    dropped, exactly as the reference drops it.

The reference's third path, expert parallelism over a mesh
(``moe_forward_ep``: shard_map + all_to_all), waits for the port's
multi-device work; ``mode="ep"`` runs the grouped path, as the reference
does without a mesh. Both paths return ``(y, aux_loss)``, aux_loss the
load-balancing loss E * sum_e(f_e * p_e) * aux_loss_weight.

Expert weights are (E, D, F) / (E, F, D) in ``param_dtype``; the router is
(D, E) in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, dtype_of, mlp_act_fn


def _experts_init(generator, shape, dtype, device) -> torch.Tensor:
    """An (E, ...) expert tensor drawn one expert at a time, so the fp32
    draw is one expert's transient, not the whole tensor's (kimi-k2's
    (384, 7168, 2048) would be 22.5 GB in fp32)."""
    w = torch.empty(shape, dtype=dtype, device=device)
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


def _routing(cfg, p: Params, x2d: torch.Tensor):
    """x2d: (T, D) -> (probs (T, E) f32, topk_w (T, K) f32, topk_idx (T, K)
    int64, aux). Ties in the top-k go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
    makes no such promise)."""
    e = cfg.moe
    logits = x2d.float() @ p["router"]  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_w, topk_idx = topk_w[:, :e.experts_per_token], topk_idx[:, :e.experts_per_token]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss
    T = x2d.shape[0]
    routed = torch.bincount(topk_idx.reshape(-1), minlength=e.num_experts).float()
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


def moe_forward_dense(cfg, p: Params, x: torch.Tensor, *,
                      capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch: one group per batch row; each expert takes at most
    ``capacity`` (default ``gshard_capacity``) of the group's pairs."""
    e = cfg.moe
    B, S, D = x.shape
    G, Tg, K, E = B, S, e.experts_per_token, e.num_experts
    _, topk_w, topk_idx, aux = _routing(cfg, p, x.reshape(G * Tg, D))
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


def moe_forward(cfg, p: Params, x: torch.Tensor,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe.mode``: "dense" runs GShard dispatch; "ep" runs
    the grouped path, the reference's choice without a mesh. Expert
    parallelism over a mesh (the reference's ``moe_forward_ep``) is not
    ported yet: a ``mesh`` raises."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism over a mesh is not ported yet "
                                  "(ROADMAP.md, the multi-device item)")
    mode = cfg.moe.mode
    if mode == "ep":
        return moe_forward_grouped(cfg, p, x)
    if mode == "dense":
        return moe_forward_dense(cfg, p, x)
    raise ValueError(f"moe mode {mode!r}; the port has 'dense' and 'ep'")
