"""Dense language model: init, forward/prefill and decode (the dense family
of ``repro.models.lm``).

Parameters are a plain dict, as in the reference, with weights in the
reference's (in, out) orientation (used as ``x @ W``). The reference stacks
the layers on a leading L axis and runs them under ``lax.scan``; here
``params["blocks"]`` is a list of per-layer dicts, looped in Python.

The KV cache is a dict ``{"length": int, "kv_k", "kv_v"}`` with
(L, B, M, Hkv, hd) tensors, bf16 when ``cfg.dtype == "bfloat16"``. Decode
updates it IN PLACE (the reference donates the buffers instead), so a cache
passed to ``decode_step`` must not be reused by the caller afterwards.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    Params,
    apply_norm,
    dense_init,
    dtype_of,
    mlp_forward,
    mlp_init,
    norm_param_init,
)
from repro_torch.models.rope import rope_angles

Cache = Dict[str, Any]


# ===========================================================================
# Parameters
# ===========================================================================


def _check_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the port has the dense family only, not {cfg.family!r}")


def _dense_layer_init(cfg, generator, device) -> Params:
    p: Params = {}
    p.update({f"ln1_{k}": v for k, v in norm_param_init(cfg, cfg.d_model, device).items()})
    p.update({f"ln2_{k}": v for k, v in norm_param_init(cfg, cfg.d_model, device).items()})
    p["attn"] = attn.attn_init(cfg, generator, device)
    p["mlp"] = mlp_init(cfg, generator, device, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random parameters on ``device``: ``0.02 * N(0, 1)`` drawn in fp32 and
    cast to ``param_dtype``, one tensor at a time; norm scales 1 and biases
    0 in fp32 (the reference's distribution). ``generator`` must live on
    ``device``."""
    _check_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, device)}
    p.update({f"final_{k}": v for k, v in norm_param_init(cfg, cfg.d_model, device).items()})
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), dt, device)
    p["blocks"] = [_dense_layer_init(cfg, generator, device) for _ in range(cfg.num_layers)]
    return p


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: torch rejects it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(cfg, params_np: Params) -> Params:
    """The port's (CPU) parameters from a ``repro.models.lm.init_params``
    pytree given as numpy arrays. Unstacks the leading layer axis of
    ``params_np["blocks"]`` into per-layer dicts; keeps the (in, out)
    orientation, the dtypes (bf16 via a uint16 view) and the names."""
    _check_dense(cfg)
    out = {k: _tree_map(_from_numpy, v) for k, v in params_np.items() if k != "blocks"}
    stacked = _tree_map(_from_numpy, params_np["blocks"])
    out["blocks"] = [_tree_map(lambda t: t[i].clone(), stacked)
                     for i in range(cfg.num_layers)]
    return out


def params_to(params: Params, device) -> Params:
    """The same parameters on ``device`` (no copy where already there)."""
    return _tree_map(lambda t: t.to(device), params)


# ===========================================================================
# Cache, embedding, logits
# ===========================================================================


def init_cache(cfg, batch: int, max_len: int, device) -> Cache:
    """Zeroed cache for ``batch`` sequences of up to ``max_len`` tokens."""
    _check_dense(cfg)
    kv_dt = dtype_of(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "length": 0,
        "kv_k": torch.zeros(shape, dtype=kv_dt, device=device),
        "kv_v": torch.zeros(shape, dtype=kv_dt, device=device),
    }


def _check_ids(cfg, tokens: torch.Tensor) -> None:
    """Raise on an id outside [0, vocab_size): the reference's ``jnp.take``
    fills such rows with NaN. Called on prompts only (one device sync per
    prefill); decode ids come from the model's own argmax over the vocab."""
    if tokens.numel():
        lo, hi = (int(t) for t in torch.aminmax(tokens))
        if lo < 0 or hi >= cfg.vocab_size:
            raise ValueError(
                f"token ids in [{lo}, {hi}] fall outside the vocabulary "
                f"[0, {cfg.vocab_size}) of {cfg.name}"
            )


def _embed(cfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> x (B, S, D)."""
    return params["embed"][tokens].to(dtype_of(cfg.dtype))


def _logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params, "final", x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w


# ===========================================================================
# Forward (prefill) and decode
# ===========================================================================


def forward(
    cfg,
    params: Params,
    tokens: torch.Tensor,
    *,
    want_cache: bool = False,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full-sequence forward. Returns (logits (B, S, V), cache-or-None);
    the cache covers ``cache_len`` positions (default S) with S filled."""
    _check_dense(cfg)
    _check_ids(cfg, tokens)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    cache = init_cache(cfg, B, cache_len or S, x.device) if want_cache else None
    for i, p in enumerate(params["blocks"]):
        h, (k, v) = attn.attention_seq(cfg, p["attn"], apply_norm(cfg, p, "ln1", x),
                                       cos, sin)
        x = x + h
        x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p, "ln2", x))
        if cache is not None:
            cache["kv_k"][i, :, :S] = k
            cache["kv_v"][i, :, :S] = v
    if cache is not None:
        cache["length"] = S
    return _logits(cfg, params, x), cache


def prefill(cfg, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    return forward(cfg, params, tokens, want_cache=True, cache_len=cache_len)


def decode_step(cfg, params: Params, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1) int. Every row decodes at the one
    shared position ``cache["length"]`` (the reference's semantics,
    lm.py:601-604): its K/V goes to slot ``min(length, M - 1)`` (the
    reference's clamp, attention.py:256) and every row attends over the
    slots up to it. Returns (logits (B, 1, V), cache) — the cache tensors
    are updated in place and returned with ``length + 1``."""
    _check_dense(cfg)
    length = int(cache["length"])
    x = _embed(cfg, params, tokens)
    B = x.shape[0]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    slot = min(length, cache["kv_k"].shape[2] - 1)
    lengths = torch.full((B,), slot + 1, dtype=torch.int32, device=x.device)
    for i, p in enumerate(params["blocks"]):
        h = attn.attention_decode(cfg, p["attn"], apply_norm(cfg, p, "ln1", x), cos, sin,
                                  cache["kv_k"][i], cache["kv_v"][i], slot, lengths)
        x = x + h
        x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p, "ln2", x))
    logits = _logits(cfg, params, x)
    return logits, {"length": length + 1, "kv_k": cache["kv_k"], "kv_v": cache["kv_v"]}
