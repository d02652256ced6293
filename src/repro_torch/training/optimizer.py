"""Optimizers: AdamW and Adafactor-mini (the twin of
``repro.training.optimizer``).

Pure-tree implementation: a state is a tree with the parameters' structure
(nested dicts and lists of tensors, as ``models/lm.py`` builds them), so a
checkpoint stores it beside the parameters. ``AdamWConfig.state_dtype``
sets the precision of ``m``/``v`` (bf16 states for the largest MoE). The
updates are functional: they return new trees and leave their inputs as
they were. Bias corrections are fp32 tensor powers, as the reference
computes them (a Python float power would be fp64).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every tuple leaf of a tree ``tree_map`` built."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig, *,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping. ``gnorm`` is the gradients'
    global norm where the caller computed it (shards of a sharded model:
    ``train_step``), else ``global_norm(grads)``."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    dt = _state_dtype(cfg)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        newp = p.float() - cfg.lr * delta
        return newp.to(p.dtype), m32.to(dt), v32.to(dt)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor-mini: factored second moment (the memory-lean alternative)
# ---------------------------------------------------------------------------


def adafactor_init(params: Any) -> Dict[str, Any]:
    def fac(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"r": torch.zeros(p.shape[:-1], **f32),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    device = tree_leaves(params)[0].device
    return {"vs": tree_map(fac, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adafactor_update(params, grads, state, lr: float = 1e-3, eps: float = 1e-30):
    step = state["step"] + 1
    beta = 1.0 - step.float() ** -0.8

    def upd(p, g, v):
        g = g.float()
        g2 = torch.square(g) + eps
        if p.dim() >= 2:
            r = beta * v["r"] + (1 - beta) * g2.mean(-1)
            c = beta * v["c"] + (1 - beta) * g2.mean(-2)
            denom = (r[..., None] * c[..., None, :]
                     / torch.clamp(r.mean(-1, keepdim=True)[..., None], min=eps))
            upd_ = g * torch.rsqrt(denom + eps)
            newv = {"r": r, "c": c}
        else:
            nv = beta * v["v"] + (1 - beta) * g2
            upd_ = g * torch.rsqrt(nv + eps)
            newv = {"v": nv}
        newp = p.float() - lr * upd_
        return newp.to(p.dtype), newv

    out = tree_map(upd, params, grads, state["vs"])
    return _pick(out, 0), {"vs": _pick(out, 1), "step": step}
