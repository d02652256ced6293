"""Shared layers: norms, activations, the MLP block, token shift, dtype and
device helpers (the port of ``repro.models.common``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def tree_leaves(tree: Any) -> list:
    """Leaves of a parameter tree in order: dict values in insertion order,
    lists and tuples by index."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (where ``tree`` has a leaf, the subtree of ``rest`` there is
    passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


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


def token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift the sequence right by one; position 0 receives ``prev`` (or
    zeros). x: (B, S, D); prev: (B, D) carried state."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# Activations and the dense MLP block
# ---------------------------------------------------------------------------


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation, not torch's exact
    erf form."""
    return F.gelu(x, approximate="tanh")


def mlp_act_fn(name: str):
    """The activation of a non-gated MLP (swiglu is gate * up, built by the
    caller)."""
    return {"squared_relu": squared_relu, "gelu": gelu}[name]


def mlp_init(cfg, generator, device, d_model: int, d_ff: int) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p: Params = {}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dt, device)
    p["w_up"] = dense_init(generator, (d_model, d_ff), dt, device)
    p["w_down"] = dense_init(generator, (d_ff, d_model), dt, device)
    return p


def mlp_forward(cfg, p: Params, x: torch.Tensor, ctx=None, spec=None) -> torch.Tensor:
    """The MLP block. Under a mesh (``ctx`` with the block's weight
    ``spec``, ``models/parallel.py``) with ``w_down``'s rows split over tp:
    the rank's columns of the up projections (Megatron column / row), then
    a ``psum`` over tp; where the guard left d_ff whole, the block runs
    whole on each rank."""
    tp = ctx is not None and ctx.mesh is not None and ctx.tp and ctx.tp in (
        (spec["w_down"][0],) if isinstance(spec["w_down"][0], str)
        else tuple(spec["w_down"][0] or ()))
    if tp:
        from repro_torch.distributed import mesh_compat as mc

        x = mc.fan_out(x, ctx.mesh, ctx.tp)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = mlp_act_fn(cfg.mlp_act)(x @ p["w_up"])
    if tp:
        from repro_torch.models.parallel import reduce_out

        return reduce_out(ctx, h @ p["w_down"])
    return h @ p["w_down"]
