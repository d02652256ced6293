"""Gradient compression with error feedback (the twin of
``repro.training.grad_compress``).

Block-wise symmetric int8 quantization cuts the bytes of a gradient
all-reduce 4x against fp32; error feedback keeps the quantization residual
locally and adds it back next step (Seide et al.; Karimireddy et al.).
Here: ``quantize_int8``/``dequantize_int8``, ``compress_with_ef`` and the
EF state threading. ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 payloads equal the reference's.

``compressed_allreduce`` is the int8 all-reduce itself over a mesh axis
(``distributed/mesh_compat.py``): a shared per-block scale by ``pmax``,
the int8 blocks summed as int32 by ``psum``, the mean, and the
error-feedback residual.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import mesh_compat as mc
from repro_torch.models.common import tree_leaves, tree_map

BLOCK = 256  # quantization block (one scale a block)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize_int8(x: torch.Tensor) -> Dict[str, Any]:
    """Block-wise symmetric int8 quantization -> payload dict."""
    flat, pad = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale, "pad": pad, "shape": tuple(x.shape)}


def dequantize_int8(payload: Dict[str, Any], dtype=torch.float32) -> torch.Tensor:
    deq = payload["q"].float() * payload["scale"]
    n = 1
    for d in payload["shape"]:
        n *= d
    return deq.reshape(-1)[:n].reshape(payload["shape"]).to(dtype)


def compress_with_ef(grad: torch.Tensor, ef: Optional[torch.Tensor]
                     ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(payload to reduce, new error-feedback residual)."""
    g = grad.float()
    if ef is not None:
        g = g + ef
    payload = quantize_int8(g)
    return payload, g - dequantize_int8(payload)


def ef_state_init(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def compressed_allreduce(grads: Any, ef_state: Any, mesh, axis) -> Tuple[Any, Any]:
    """The mean of ``grads`` over the mesh axis ``axis`` through an int8
    payload, with error feedback: returns (mean grads, new EF residuals),
    each in the trees' structure.

    A SHARED per-block scale (``pmax`` over the axis) makes the int32 sum an
    exact fixed-point sum: err <= shared_scale / 2 per element. The cheap
    ``pmax`` of scales (4 bytes a block) precedes the ``psum`` of the int8
    values widened to int32 (the backends sum no int8 without overflow);
    the residual each rank keeps is its own quantization error."""
    n = mc.axis_size(mesh, axis)

    def one(g, ef):
        gq = g.float() + (ef if ef is not None else 0.0)
        # divide by tensors on gq's device: CUDA divides by a host scalar as
        # a multiply by its reciprocal, which rounds otherwise than the CPU
        c127, cn = (torch.tensor(c, dtype=torch.float32, device=gq.device) for c in (127.0, n))
        flat, _ = _pad_to_block(gq)
        blocks = flat.reshape(-1, BLOCK)
        local_scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / c127
        scale = mc.pmax(torch.clamp(local_scale, min=1e-12), mesh, axis)
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        size = gq.numel()
        new_ef = (blocks - q.float() * scale).reshape(-1)[:size].reshape(gq.shape)
        qsum = mc.psum(q.to(torch.int32), mesh, axis)
        deq = qsum.float() * scale / cn  # mean gradient
        out = deq.reshape(-1)[:size].reshape(gq.shape).to(g.dtype)
        return out, new_ef

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef_state))]
    outs, efs = iter([o for o, _ in pairs]), iter([e for _, e in pairs])
    return tree_map(lambda _: next(outs), grads), tree_map(lambda _: next(efs), grads)


def compression_ratio(x: torch.Tensor) -> float:
    """bytes(int8 + scales) / bytes(fp32)."""
    n = x.numel()
    blocks = -(-n // BLOCK)
    return (n * 1 + blocks * 4) / (n * 4)
