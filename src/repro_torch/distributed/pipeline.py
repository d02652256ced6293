"""Pipeline parallelism: GPipe-style microbatched stage execution over a
mesh axis (the port of ``repro.distributed.pipeline``).

The layer stack (L, ...) is split into ``n_stages`` contiguous stages along
the axis; microbatches stream through: at step t, stage s runs microbatch
t - s (bubble = n_stages - 1 idle slots at each end, the GPipe trade-off).
Activations move to the next stage by ``ppermute``; the last stage collects
the outputs and a ``psum`` broadcasts them from it (every other stage holds
zeros).

Each rank runs its own stage: it takes its slice of ``stacked_params`` (the
whole stack is passed on every rank, as the reference's shard_map takes it
replicated and slices it), and the result is the whole output on every
rank. The backward comes from autograd through the collectives'
transposes: ``ppermute``'s is the reverse permutation, ``psum``'s passes
each rank's cotangent through; each rank's gradient of ``stacked_params``
is nonzero on its own stage's layers only.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import mesh_compat as mc
from repro_torch.models.common import tree_leaves, tree_map


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params: Any,
                   x: torch.Tensor, *, mesh, axis: str, n_microbatches: int) -> torch.Tensor:
    """Run x through L stacked layers, pipelined over mesh axis ``axis``.

    layer_fn(params_one_layer, h) -> h. stacked_params leaves have leading L
    divisible by the axis size. x: (B, ...) with B divisible by
    n_microbatches. Returns f(x), equal (up to rounding) to the sequential
    loop, on every rank."""
    n_stages = mesh.axis_size(axis)
    L = tree_leaves(stacked_params)[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} microbatches")
    mb, per = B // n_microbatches, L // n_stages
    sid = mesh.axis_index(axis)
    local = tree_map(lambda p: p[sid * per:(sid + 1) * per], stacked_params)
    mbs = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    fwd = [(i, i + 1) for i in range(n_stages - 1)]
    T = n_microbatches + n_stages - 1
    last = n_stages - 1
    state = torch.zeros_like(mbs[0])
    outs = []
    for t in range(T):
        # stage 0 ingests microbatch t (clamped; the extra steps are masked).
        # Every received state and every step's output stays in each rank's
        # autograd graph (times 0 where unused), so that every rank runs the
        # same collectives, in the same order, in the backward.
        if sid == 0:
            h = mbs[min(t, n_microbatches - 1)] + 0 * state
        else:
            h = state
        for i in range(per):
            h = layer_fn(tree_map(lambda p: p[i], local), h)
        if t >= last:  # microbatch t - last exits the last stage
            outs.append(h if sid == last else h * 0)
        # shift activations to the next stage
        state = mc.ppermute(h, mesh, axis, fwd)
    out = (torch.stack(outs) + 0 * state[None]).to(x.dtype)
    out = mc.psum(out, mesh, axis)  # broadcast from the last stage
    return out.reshape((B,) + tuple(x.shape[1:]))


def sequential_reference(layer_fn, stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
    """Oracle: a plain loop over the layer stack."""
    L = tree_leaves(stacked_params)[0].shape[0]
    h = x
    for i in range(L):
        h = layer_fn(tree_map(lambda p: p[i], stacked_params), h)
    return h
