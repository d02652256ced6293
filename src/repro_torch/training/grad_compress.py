"""Gradient compression with error feedback (the twin of
``repro.training.grad_compress``).

Block-wise symmetric int8 quantization cuts the bytes of a gradient
all-reduce 4x against fp32; error feedback keeps the quantization residual
locally and adds it back next step (Seide et al.; Karimireddy et al.).
Here: ``quantize_int8``/``dequantize_int8``, ``compress_with_ef`` and the
EF state threading. ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 payloads equal the reference's.

``compressed_allreduce`` reduces over a mesh axis; it waits for the port's
multi-device work (ROADMAP §1, item 4, "Multi-device") and raises until
then.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.common import tree_map

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


def compressed_allreduce(grads: Any, ef_state: Any, axis_name: str):
    """The int8 all-reduce with error feedback over a mesh axis: not ported
    until the multi-device item (ROADMAP §1, item 4)."""
    raise NotImplementedError(
        "compressed_allreduce reduces over a mesh axis; it comes with the port's "
        "multi-device work (ROADMAP §1, item 4, Multi-device)")


def compression_ratio(x: torch.Tensor) -> float:
    """bytes(int8 + scales) / bytes(fp32)."""
    n = x.numel()
    blocks = -(-n // BLOCK)
    return (n * 1 + blocks * 4) / (n * 4)
