"""Shared layers: norms, activations, the MLP block, dtype and device
helpers (the dense parts of ``repro.models.common``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the port on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Norms. All norms compute in fp32 and cast back (the reference's convention).
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6):
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(orig)


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
):
    orig = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(orig)


def apply_norm(cfg, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Dispatch on cfg.norm_type; ``p`` holds <name>_scale/<name>_bias if any."""
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p[f"{name}_scale"])
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"])
    if cfg.norm_type == "layernorm_np":  # OLMo: non-parametric
        return layer_norm(x, None, None)
    raise ValueError(cfg.norm_type)


def norm_param_init(cfg, d: int, device) -> Params:
    """Norm params for one norm site (empty for layernorm_np), in fp32."""
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {
            "scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device),
        }
    return {}


def dense_init(generator: torch.Generator, shape, dtype, device, scale: float = 0.02):
    """``scale * N(0, 1)`` drawn in fp32 on ``device``, cast to ``dtype``
    (the reference's distribution; the draws themselves differ)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Activations and the dense MLP block
# ---------------------------------------------------------------------------


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def mlp_init(cfg, generator, device, d_model: int, d_ff: int) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p: Params = {}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dt, device)
    p["w_up"] = dense_init(generator, (d_model, d_ff), dt, device)
    p["w_down"] = dense_init(generator, (d_ff, d_model), dt, device)
    return p


def mlp_forward(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_act == "squared_relu":
        h = squared_relu(x @ p["w_up"])
    else:
        raise ValueError(cfg.mlp_act)
    return h @ p["w_down"]
