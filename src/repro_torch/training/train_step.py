"""Training step: loss, gradients, optimizer update, with optional
vocab-chunked cross-entropy and gradient accumulation over microbatches
(the twin of ``repro.training.train_step``).

The loss runs ``lm.forward(..., use_kernels=False)``: the model code the
reference trains through, with autograd, and none of the kernels (which
have no backward). Gradients come from ``torch.autograd.grad`` with respect
to detached copies of the parameters, so the step is functional like the
reference's: it returns new parameter and optimizer trees.

Under a mesh (``ctx``, ``models/parallel.py``) each rank passes its shards
of the parameters and optimizer state and its rows of the batch: the loss
is the mean over the global batch (the ranks' means ``psum``'d over dp,
equal shards), each gradient is summed over the dp axes its parameter is
not sharded on (an FSDP shard's was reduce-scattered in the backward), the
clipping norm is over every shard once, and AdamW updates the local shards.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm
from repro_torch.models import parallel as par
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  chunk_vocab: int = 0) -> torch.Tensor:
    """Mean token NLL. logits (B, S, V) any dtype; labels (B, S) int.
    ``chunk_vocab`` > 0 takes the logsumexp over vocabulary chunks (a
    bound on the fp32 temporaries)."""
    lg = logits.float()
    V = logits.shape[-1]
    if chunk_vocab and V > chunk_vocab:
        chunks = [lg[..., i:i + chunk_vocab] for i in range(0, V, chunk_vocab)]
        m = torch.full(lg.shape[:-1], float("-inf"), dtype=torch.float32, device=lg.device)
        for c in chunks:
            m = torch.maximum(m, c.amax(-1))
        s = torch.zeros(lg.shape[:-1], dtype=torch.float32, device=lg.device)
        for c in chunks:
            s = s + torch.exp(c - m[..., None]).sum(-1)
        lse = m + torch.log(s)
    else:
        lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor], ctx=None
            ) -> Tuple[torch.Tensor, Dict]:
    """nll + aux over ``batch`` (``tokens`` or vlm ``embeds`` with
    ``positions``, audio ``frames``, and ``labels``). As in the reference,
    ``positions`` are read only with ``embeds``. Under a mesh the nll is
    the global batch's mean (module docstring)."""
    embeds = batch.get("embeds")
    logits, aux, _ = lm.forward(
        cfg, params, batch.get("tokens"), embeds=embeds,
        positions=batch.get("positions") if embeds is not None else None,
        frames=batch.get("frames"), use_kernels=False, ctx=ctx)
    nll = cross_entropy(logits, batch["labels"])
    if par.active(ctx) and ctx.dp:
        nll = mc.psum(nll, ctx.mesh, ctx.dp) / ctx.mesh.axis_size(ctx.dp)
    return nll + aux, {"nll": nll, "aux": aux}


def value_and_grad(cfg, params, batch, ctx=None) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, metrics, grads): grads in the parameters' tree and dtypes."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch, ctx)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _axes_of(spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in shd.entry_axes(e))


def reduce_grads(ctx, specs, grads) -> Tuple[Any, torch.Tensor]:
    """(grads summed over the dp axes each parameter is not sharded on,
    their global norm over every shard once)."""
    def red(g, spec):
        over = tuple(a for a in ctx.dp if a not in _axes_of(spec))
        return mc.psum(g, ctx.mesh, over) if over else g

    grads = shd.map_with_specs(red, grads, specs)
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(tree_leaves(grads), shd.spec_leaves(specs)):
        key = tuple(a for a in ctx.mesh.axis_names if a in _axes_of(spec))
        sums[key] = sums.get(key, 0.0) + torch.sum(torch.square(g.float()))
    total = 0.0
    for key, s in sums.items():
        total = total + (mc.psum(s, ctx.mesh, key) if key else s)
    return grads, torch.sqrt(total)


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, ctx=None,
                    microbatch: int = 0):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics as 0-d tensors on the parameters' device. With ``microbatch`` >
    1 the batch splits into that many equal parts whose fp32 gradients are
    averaged (the vlm's (3, B, S) positions split on their B axis). Under a
    mesh (``ctx``) the trees and the batch are the rank's (module
    docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()
    ctx = ctx if par.active(ctx) else None

    def train_step(params, opt_state, batch):
        if microbatch and microbatch > 1:
            B = batch["labels"].shape[0]
            mb = B // microbatch

            def reshard(x):
                if x.dim() >= 1 and x.shape[0] == B:
                    return x.reshape(microbatch, mb, *x.shape[1:])
                if x.dim() == 3 and x.shape[0] == 3:  # vlm positions (3, B, S)
                    return x.reshape(3, microbatch, mb, x.shape[2]).permute(1, 0, 2, 3)
                return x.expand((microbatch,) + tuple(x.shape))

            parts = {k: reshard(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            losses = []
            for i in range(microbatch):
                loss_i, _, g = value_and_grad(cfg, params, {k: v[i] for k, v in parts.items()},
                                              ctx)
                grads = tree_map(lambda a, b: a + b, grads, g)
                losses.append(loss_i)
            grads = tree_map(lambda g: g / microbatch, grads)
            metrics = {"loss": torch.mean(torch.stack(losses))}
        else:
            loss, m, grads = value_and_grad(cfg, params, batch, ctx)
            metrics = {"loss": loss, **m}
        gnorm = None
        if ctx is not None:
            grads, gnorm = reduce_grads(ctx, ctx.param_specs(cfg), grads)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg, gnorm=gnorm)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
