"""Language model: init, forward/prefill and decode for every family of
``repro.models.lm``: dense (with qk-norm: qwen3-4b), moe (granite-moe,
kimi-k2), ssm (rwkv6), hybrid (zamba2), vlm (qwen2-vl: M-RoPE and the
``embeds`` input of its stub frontend) and audio (whisper: encoder-decoder
with cross-attention over the stub frontend's ``frames``); and the port's
own nemotron_h (Nemotron-H: one mixer a layer, Mamba-2, MLP or attention,
by ``cfg.hybrid_pattern``; ``PORT_ONLY_FAMILIES``).

Parameters are a plain dict, as in the reference, with weights in the
reference's (in, out) orientation (used as ``x @ W``). The reference stacks
the layers on a leading L axis (hybrid: (G, attn_every)) and runs them
under ``lax.scan``; here ``params["blocks"]`` is a list of per-layer dicts
(hybrid: a list of G groups, each a list of ``attn_every`` layer dicts;
audio: ``enc_blocks`` and ``dec_blocks``), looped in Python. The hybrid
family's one shared attention block is ``params["shared_attn"]``, a dense
layer applied after every group. A moe layer holds ``moe`` (router and
(E, D, F) experts, ``models/moe.py``) where a dense layer holds ``mlp``. A
nemotron_h layer holds ``ln1_scale`` and one of ``mamba``, ``mlp`` or
``attn``: ``x + mixer(RMSNorm(x))``; its attention has no position
encoding. The nemotron_h family runs on one device: under a mesh it raises.

Under a mesh (``ctx``, a ``ParallelCtx``; ``models/parallel.py``) every
rank passes its shard of the parameters (``distributed.sharding.shard_tree``
by ``param_pspecs``) and of the batch (its rows), and gets full-vocabulary
logits for its rows. A layer's FSDP-sharded weights are all-gathered as the
layer starts; attention and the MLP run Megatron-style on the rank's heads
and columns, each ending in a ``psum`` over tp; the embedding is a masked
lookup of the rank's vocabulary rows and a ``psum``; the head gives the
rank's vocabulary columns, all-gathered over tp. The cache is the rank's
block of the whole cache under ``cache_pspecs`` (batch over dp; kv heads,
head dim or sequence over tp), with ``max_len`` (and audio's ``enc_len``)
of the whole cache beside ``length``; the recurrent state is the rank's
heads', the shift and conv carries its block of the whole ones. Every
family runs tensor parallel (the recurrent families' mixers in
``rwkv.py`` and ``mamba.py``). A moe in mode "ep" goes through
``moe.moe_forward_ep``; in mode "dense" each rank runs every expert on its
rows. Where a gradient is taken, the profile's ``remat`` applies to each
layer as the reference's ``_maybe_remat`` does (``_remat``: "full" keeps a
layer's inputs, "dots" its matrix products too). With the profile's
``seq_parallel`` a forward over more than one position keeps the residual
stream sequence-sharded over tp between sublayers (``models/parallel.py``);
the audio family runs without it, as the reference constrains no
sequence there.

Caches are dicts with a Python int ``length``:

* dense, moe, vlm: ``kv_k``/``kv_v`` (L, B, M, Hkv, hd), bf16 when
  ``cfg.dtype == "bfloat16"``;
* audio: the decoder's ``kv_k``/``kv_v`` as above and the cross-attention
  K/V of the encoder output, ``cross_k``/``cross_v`` (L, B, T, Hkv, hd);
* ssm: ``ssm_state`` (L, B, H, N, N) fp32 and the token-shift carries
  ``shift_tm``/``shift_cm`` (L, B, D) in ``cfg.dtype``;
* hybrid: ``ssm_state`` (G, per, B, heads, P, Ns) fp32, ``conv``
  (G, per, B, K-1, CH) in ``cfg.dtype``, and ``kv_k``/``kv_v``
  (G, B, M, Hkv, hd), one KV slot per application of the shared block;
* nemotron_h: ``ssm_state`` (Lm, B, heads, P, Ns) fp32 and ``conv``
  (Lm, B, K-1, CH) in ``cfg.dtype`` for its Lm Mamba-2 layers, and
  ``kv_k``/``kv_v`` (La, B, M, Hkv, hd) for its La attention layers, in
  layer order.

Decode updates the cache IN PLACE (the reference donates the buffers
instead), so a cache passed to ``decode_step`` must not be reused by the
caller afterwards. Without a mesh a cache may also carry ``pos``, a 0-d
int32 tensor on its device equal to ``length``: ``decode_step`` reads the
position from it (from a tensor it makes of ``length`` where the cache
has none) and advances it in place, so that no launch of the step depends
on a host value (``serving.Engine`` captures the step in a CUDA graph).
``prefill`` and ``prefill_extend`` take a cache as ``cache=`` and fill it
in place of a new one, ``pos`` included.

``forward`` returns ``(logits, aux, cache)`` as the reference does, aux
the MoE layers' summed load-balancing loss (0 without them). Its
``use_kernels=False`` is the training path: the model code the reference
trains through (``use_pallas`` False by default), with autograd and no
kernel: attention as ``attention.naive_attention`` (or its chunked online
softmax past 512 positions), the scans as the chunked forms. Every serving
entry point (``prefill``, ``prefill_extend``, ``decode_step``) runs the
kernels, whose CUDA wrappers refuse inputs that require grad.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel as par
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (
    Params,
    apply_norm,
    dense_init,
    dtype_of,
    mlp_forward,
    mlp_init,
    norm_param_init,
    tree_map,
)
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.rope import positions_for_rope
from repro_torch.obs import trace_span
from repro_torch.obs.port_names import SPAN_MODEL_MAMBA

Batch = Dict[str, torch.Tensor]
Cache = Dict[str, Any]
# families of the port alone, each with its reason: nemotron_h is
# Nemotron-H (hybrid_override_pattern: Mamba-2 with B/C groups, MLP and
# attention layers in one stack), the hybrid generation of APC's large
# planner, which the reference does not model
PORT_ONLY_FAMILIES = ("nemotron_h",)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio") + PORT_ONLY_FAMILIES
# nemotron_h's layer kinds: one pattern character a layer
MAMBA, MLP, ATTN = "M", "-", "*"
DEC_POS_ROWS = 32_776  # whisper's learned decoder positions (the reference's table)


# ===========================================================================
# Parameters
# ===========================================================================


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port has the {', '.join(FAMILIES)} families, not {cfg.family!r}")
    if cfg.family == "hybrid" and cfg.num_layers // cfg.attn_every == 0:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers make no group of "
                         f"attn_every={cfg.attn_every}; the model would run no layer")
    if cfg.family == "nemotron_h":
        layer_kinds(cfg)


def _single_device(cfg, ctx) -> None:
    """nemotron_h runs on one device."""
    if cfg.family == "nemotron_h" and ctx is not None:
        raise NotImplementedError(f"{cfg.name}: the nemotron_h family runs on one device, "
                                  "not under a mesh")


def layer_kinds(cfg) -> str:
    """nemotron_h: each layer's kind, the first ``num_layers`` characters of
    ``cfg.hybrid_pattern`` (``MAMBA``, ``MLP`` or ``ATTN``)."""
    kinds = cfg.hybrid_pattern[:cfg.num_layers]
    if len(kinds) != cfg.num_layers or set(kinds) - {MAMBA, MLP, ATTN}:
        raise ValueError(f"{cfg.name}: hybrid_pattern {cfg.hybrid_pattern!r} gives no kind "
                         f"in {MAMBA + MLP + ATTN!r} to each of {cfg.num_layers} layers")
    return kinds


def layer_counts(cfg) -> Tuple[int, int]:
    """(Mamba-2 layers, attention layers) of a hybrid model: the zamba2
    family's mixers and shared-block applications, or nemotron_h's layers
    of each kind; (0, 0) for the other families."""
    if cfg.family == "nemotron_h":
        kinds = layer_kinds(cfg)
        return kinds.count(MAMBA), kinds.count(ATTN)
    if cfg.family == "hybrid":
        return _groups(cfg) * cfg.attn_every, _groups(cfg)
    return 0, 0


def state_bytes(cache: Cache) -> int:
    """The bytes of recurrent state a cache holds: SSM state, conv and
    token-shift carries (0 for a pure-KV cache)."""
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("ssm_state", "conv", "shift_tm", "shift_cm") if k in cache)


def _groups(cfg) -> int:
    """Hybrid: the number of (attn_every mamba layers + shared block) groups."""
    return cfg.num_layers // cfg.attn_every


def _norms(cfg, names, device) -> Params:
    return {f"{nm}_{k}": v for nm in names
            for k, v in norm_param_init(cfg, cfg.d_model, device).items()}


def _dense_layer_init(cfg, generator, device) -> Params:
    p = _norms(cfg, ("ln1", "ln2"), device)
    p["attn"] = attn.attn_init(cfg, generator, device)
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_init(cfg, generator, device)
    else:
        p["mlp"] = mlp_init(cfg, generator, device, cfg.d_model, cfg.d_ff)
    return p


def _whisper_dec_layer_init(cfg, generator, device) -> Params:
    p = _norms(cfg, ("ln1", "ln2", "ln3"), device)
    p["attn"] = attn.attn_init(cfg, generator, device)
    p["cross"] = attn.cross_attn_init(cfg, generator, device)
    p["mlp"] = mlp_init(cfg, generator, device, cfg.d_model, cfg.d_ff)
    return p


def _rwkv_layer_init(cfg, generator, device) -> Params:
    p = _norms(cfg, ("ln1", "ln2"), device)
    p["rwkv"] = rwkv_mod.rwkv_init(cfg, generator, device)
    return p


def _mamba_layer_init(cfg, generator, device) -> Params:
    p = _norms(cfg, ("ln1",), device)
    p["mamba"] = mamba_init_wrap(cfg, generator, device)
    return p


def mamba_init_wrap(cfg, generator, device) -> Params:
    return mam.mamba_init(cfg, generator, device)


def _nemotron_layer_init(cfg, kind: str, generator, device) -> Params:
    p = _norms(cfg, ("ln1",), device)
    if kind == MAMBA:
        p["mamba"] = mam.mamba_init(cfg, generator, device)
    elif kind == ATTN:
        p["attn"] = attn.attn_init(cfg, generator, device)
    else:
        p["mlp"] = mlp_init(cfg, generator, device, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random parameters on ``device``: ``0.02 * N(0, 1)`` drawn in fp32 and
    cast to ``param_dtype``, one tensor at a time; norm scales 1 and biases
    0 in fp32 (the reference's distribution; the rwkv and mamba mixers
    draw theirs, see ``rwkv_init`` and ``mamba_init``; whisper's ``dec_pos``
    is drawn at 0.01). ``generator`` must live on ``device``."""
    _check_family(cfg)
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, device)}
    p.update(_norms(cfg, ("final",), device))
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), dt, device)
    if cfg.family == "audio":  # whisper
        p["enc_blocks"] = [_dense_layer_init(cfg, generator, device)  # attention + MLP
                           for _ in range(cfg.encoder.num_layers)]
        p["dec_blocks"] = [_whisper_dec_layer_init(cfg, generator, device)
                           for _ in range(cfg.num_layers)]
        p.update(_norms(cfg, ("enc_final",), device))
        p["dec_pos"] = dense_init(generator, (DEC_POS_ROWS, cfg.d_model), dt, device,
                                  scale=0.01)
    elif cfg.family == "ssm":  # rwkv6
        p["blocks"] = [_rwkv_layer_init(cfg, generator, device)
                       for _ in range(cfg.num_layers)]
        p.update(_norms(cfg, ("ln0",), device))
    elif cfg.family == "hybrid":  # zamba2
        p["blocks"] = [[_mamba_layer_init(cfg, generator, device)
                        for _ in range(cfg.attn_every)] for _ in range(_groups(cfg))]
        p["shared_attn"] = _dense_layer_init(cfg, generator, device)
    elif cfg.family == "nemotron_h":
        p["blocks"] = [_nemotron_layer_init(cfg, k, generator, device)
                       for k in layer_kinds(cfg)]
    else:
        p["blocks"] = [_dense_layer_init(cfg, generator, device)
                       for _ in range(cfg.num_layers)]
    return p


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: torch rejects it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(cfg, params_np: Params) -> Params:
    """The port's (CPU) parameters from a ``repro.models.lm.init_params``
    pytree given as numpy arrays. Unstacks the leading layer axis of
    ``params_np["blocks"]`` (audio: ``enc_blocks`` and ``dec_blocks``) into
    per-layer dicts (hybrid: the two leading axes (G, attn_every) into
    groups of layer dicts); keeps the (in, out) orientation, the dtypes
    (bf16 via a uint16 view) and the names."""
    _check_family(cfg)
    stacks = ("enc_blocks", "dec_blocks") if cfg.family == "audio" else ("blocks",)
    out = {k: tree_map(_from_numpy, v) for k, v in params_np.items() if k not in stacks}

    def unstack(tree, n):
        return [tree_map(lambda t: t[i].clone(), tree) for i in range(n)]

    for name in stacks:
        stacked = tree_map(_from_numpy, params_np[name])
        if cfg.family == "hybrid":
            out[name] = [unstack(tree_map(lambda t: t[g], stacked), cfg.attn_every)
                         for g in range(_groups(cfg))]
        else:
            n = cfg.encoder.num_layers if name == "enc_blocks" else cfg.num_layers
            out[name] = unstack(stacked, n)
    return out


def params_to(params: Params, device) -> Params:
    """The same parameters on ``device`` (no copy where already there)."""
    return tree_map(lambda t: t.to(device), params)


def abstract_params(cfg) -> Params:
    """The parameter tree on the meta device: shapes and dtypes, no storage
    (the reference's ``eval_shape`` of ``init_params``)."""
    return init_params(cfg, None, "meta")


# ===========================================================================
# Cache, embedding, logits
# ===========================================================================


def init_cache(cfg, batch: int, max_len: int, device, *, enc_len: int = 0) -> Cache:
    """Zeroed cache for ``batch`` sequences of up to ``max_len`` tokens
    (the layouts are in the module's docstring); audio's cross K/V hold
    ``enc_len`` encoder positions (default ``encoder.num_frames``)."""
    _check_family(cfg)
    dt = dtype_of(cfg.dtype)
    f32 = torch.float32
    c: Cache = {"length": 0}
    if cfg.family == "ssm":
        s = cfg.ssm
        H, L = cfg.d_model // s.head_dim, cfg.num_layers
        c["ssm_state"] = torch.zeros((L, batch, H, s.head_dim, s.head_dim), dtype=f32,
                                     device=device)
        c["shift_tm"] = torch.zeros((L, batch, cfg.d_model), dtype=dt, device=device)
        c["shift_cm"] = torch.zeros_like(c["shift_tm"])
        return c
    n_kv = cfg.num_layers
    if cfg.family == "nemotron_h":
        s = cfg.ssm
        _, heads, conv_ch = mam.mamba_dims(cfg)
        n_m, n_kv = layer_counts(cfg)
        c["ssm_state"] = torch.zeros((n_m, batch, heads, s.head_dim, s.state_dim),
                                     dtype=f32, device=device)
        c["conv"] = torch.zeros((n_m, batch, s.conv_dim - 1, conv_ch), dtype=dt, device=device)
    if cfg.family == "hybrid":
        s = cfg.ssm
        _, heads, conv_ch = mam.mamba_dims(cfg)
        G, per = _groups(cfg), cfg.attn_every
        c["ssm_state"] = torch.zeros((G, per, batch, heads, s.head_dim, s.state_dim),
                                     dtype=f32, device=device)
        c["conv"] = torch.zeros((G, per, batch, s.conv_dim - 1, conv_ch), dtype=dt,
                                device=device)
        n_kv = G
    shape = (n_kv, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    c["kv_k"] = torch.zeros(shape, dtype=dt, device=device)
    c["kv_v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.family == "audio":
        shape = (n_kv, batch, enc_len or cfg.encoder.num_frames, cfg.num_kv_heads,
                 cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return c


def abstract_cache(cfg, batch: int, max_len: int, **kw) -> Cache:
    """``init_cache`` on the meta device."""
    return init_cache(cfg, batch, max_len, "meta", **kw)


def _check_ids(cfg, tokens: torch.Tensor) -> None:
    """Raise on an id outside [0, vocab_size): the reference's ``jnp.take``
    fills such rows with NaN. Called on prompts only (one device sync per
    prefill); decode ids come from the model's own argmax over the vocab."""
    if tokens.numel() and tokens.device.type != "meta":  # meta: no values to check
        lo, hi = (int(t) for t in torch.aminmax(tokens))
        if lo < 0 or hi >= cfg.vocab_size:
            raise ValueError(
                f"token ids in [{lo}, {hi}] fall outside the vocabulary "
                f"[0, {cfg.vocab_size}) of {cfg.name}"
            )


def _embed(cfg, params: Params, tokens: torch.Tensor, ctx=None, spec=None) -> torch.Tensor:
    """tokens (B, S) int -> x (B, S, D). Under a mesh with the vocabulary
    split over tp: the rank's rows looked up (the others zero), then a
    ``psum`` over tp (under sequence parallelism a reduce-scatter: the
    rank's sequence block)."""
    if ctx is None or not par.on_tp(ctx, spec[0]):
        return params["embed"][tokens].to(dtype_of(cfg.dtype))
    emb, dt = params["embed"], dtype_of(cfg.dtype)
    n = emb.shape[0]
    ids = tokens - ctx.tp_index * n
    ok = (ids >= 0) & (ids < n)
    x = emb[ids.clamp(0, n - 1)].to(dt)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=dt, device=x.device))
    return par.reduce_out(ctx, x)


def _embed_inputs(cfg, params: Params, tokens, embeds, positions, ctx=None, specs=None):
    """(x (B, S, D), positions) from token ids, or from the vlm stub
    frontend's precomputed ``embeds`` (B, S, D) with optional ``positions``
    ((B, S), or (3, B, S) for M-RoPE); positions default to 0..S-1. Under
    sequence parallelism x is the rank's sequence block."""
    if embeds is not None:
        x = embeds.to(dtype_of(cfg.dtype))
        B, S = embeds.shape[:2]
    else:
        _check_ids(cfg, tokens)
        x = _embed(cfg, params, tokens, ctx, None if specs is None else specs["embed"])
        B, S = tokens.shape
    x = par.seq_shard(ctx, x)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def _ffn_block(cfg, p: Params, x: torch.Tensor, ctx=None, spec=None):
    """The layer's MLP, or its MoE where it has one: (y, aux loss or None)."""
    if "moe" in p:
        return moe_mod.moe_forward(cfg, p["moe"], x, ctx=ctx)
    return mlp_forward(cfg, p["mlp"], x, ctx, None if spec is None else spec["mlp"]), None


def _logits(cfg, params: Params, x: torch.Tensor, ctx=None, specs=None) -> torch.Tensor:
    """Full-vocabulary logits; under a mesh with the vocabulary split over
    tp, the rank's columns all-gathered."""
    x = apply_norm(cfg, params, "final", x)
    if cfg.tie_embeddings:
        w, vocab = params["embed"].T, None if specs is None else specs["embed"][0]
    else:
        w, vocab = params["head"], None if specs is None else specs["head"][1]
    if ctx is not None and par.on_tp(ctx, vocab):
        return mc.all_gather(par.fan_out(ctx, x) @ w, ctx.mesh, ctx.tp, dim=-1, grad="slice")
    return x @ w


# ===========================================================================
# Under a mesh
# ===========================================================================


def _mesh(cfg, ctx, params: Params):
    """(ctx or None, the whole model's specs, the non-layer weights with
    their FSDP dims gathered). The layer stacks are gathered a layer at a
    time by ``_layers``; the tp dims stay local."""
    if not par.active(ctx):
        return None, None, params
    specs = ctx.param_specs(cfg)
    keep = (ctx.tp,) if ctx.tp else ()
    stacks = ("blocks", "enc_blocks", "dec_blocks", "shared_attn")
    top = {k: par.gather_params(ctx, v, specs[k], keep) for k, v in params.items()
           if k not in stacks}
    if "shared_attn" in params:
        top["shared_attn"] = par.gather_layer(ctx, cfg, params["shared_attn"],
                                              specs["shared_attn"])
    return ctx, specs, top


def _layers(ctx, cfg, blocks, specs):
    """(weights, spec) of each layer in turn, its FSDP dims gathered as it
    comes (a hybrid group: a list of layers)."""
    for i, p in enumerate(blocks):
        if specs is None:
            yield p, None
        elif isinstance(p, list):
            yield [q for q, _ in _layers(ctx, cfg, p, specs[i])], specs[i]
        else:
            yield par.gather_layer(ctx, cfg, p, specs[i]), specs[i]


# the matrix products "dots" keeps (``jax.checkpoint_policies.checkpoint_dots``
# saves every dot_general's result): the aten ops that ``@``, ``matmul`` and
# ``einsum`` lower to
_DOTS = tuple(getattr(torch.ops.aten, n).default
              for n in ("mm", "bmm", "addmm", "baddbmm", "addbmm"))


def _dots_policy(_, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(ctx, fn):
    """The reference's ``_maybe_remat`` for one layer's ``fn``, under a mesh
    and where a gradient is taken. "full" (and "offload", which the
    reference runs as "full"): the layer keeps only its inputs and runs
    again in the backward, its collectives too, on every rank alike.
    "dots": the same rerun, but the results of its matrix products (mm,
    bmm, addmm, ...) are kept from the forward and everything else is
    recomputed (``torch.utils.checkpoint``'s selective policy). The
    collectives are ``autograd.Function``s whose forwards run again in the
    rerun like any other code, so every rank repeats the same ones; a
    product's kept result is read back in place of its recomputation."""
    mode = ctx.remat if ctx is not None else "none"
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _dots_context} if mode == "dots" else {}

    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _n_dp(ctx) -> int:
    return ctx.mesh.axis_size(ctx.dp) if ctx.dp else 1


def _new_cache(cfg, ctx, batch: int, max_len: int, device, enc_len: int = 0):
    """(zeroed cache, its specs). Under a mesh: the rank's block of the
    cache of ``batch * n_dp`` rows (its ``batch``), with ``max_len`` (and
    audio's ``enc_len``) beside ``length``; the specs are ``cache_pspecs``."""
    if ctx is None:
        return init_cache(cfg, batch, max_len, device, enc_len=enc_len), None
    kw = {"enc_len": enc_len} if enc_len else {}
    whole = abstract_cache(cfg, batch * _n_dp(ctx), max_len, **kw)
    specs = ctx.cache_specs(cfg, batch * _n_dp(ctx), max_len, **kw)
    c: Cache = {"length": 0, "max_len": max_len}
    if enc_len:
        c["enc_len"] = enc_len
    for k, v in whole.items():
        if isinstance(v, torch.Tensor):
            shape = [n // ctx.mesh.axis_size(shd.entry_axes(e)) for n, e in zip(v.shape, specs[k])]
            c[k] = torch.zeros(shape, dtype=v.dtype, device=device)
    return c, specs


def _into(cfg, ctx, cache: Cache, batch: int, n: int):
    """The specs of a caller's ``cache`` that a prefill of ``batch`` rows
    and ``n`` positions fills in place of a new one. Its positions past
    ``n`` keep what they held: a decode step reads a row only up to the
    row's length, and writes each position before it reads it."""
    kv = cache.get("kv_k")
    if kv is not None and (kv.shape[1] != batch or kv.shape[2] < n):
        raise ValueError(f"cache of {kv.shape[1]} rows x {kv.shape[2]} positions cannot "
                         f"take a prefill of {batch} rows x {n} positions")
    return _cache_specs(cfg, ctx, cache)


def _set_length(cache: Cache, n: int) -> None:
    cache["length"] = n
    if "pos" in cache:
        cache["pos"].fill_(n)


def _cache_specs(cfg, ctx, cache: Cache):
    """The specs of a cache ``_new_cache`` built under ``ctx``."""
    if ctx is None:
        return None
    if cfg.family == "hybrid":
        rows = cache["ssm_state"].shape[2]
    elif cfg.family == "ssm":
        rows = cache["ssm_state"].shape[1]
    else:
        rows = cache["kv_k"].shape[1]
    kw = {"enc_len": cache["enc_len"]} if "enc_len" in cache else {}
    return ctx.cache_specs(cfg, rows * _n_dp(ctx), cache["max_len"], **kw)


def _kv_spec(cspecs, name: str = "kv_k"):
    """A layer's (B, M, Hkv, hd) cache entries, the batch local."""
    if cspecs is None or name not in cspecs:
        return None
    return (None,) + tuple(cspecs[name][2:])


def _store_kv(cfg, ctx, cache: Cache, i: int, k, v, cspecs, names=("kv_k", "kv_v"),
              offset: int = 0):
    """Write a layer's k and v (B, S, heads, hd) at positions [offset,
    offset + S): the rank's own heads straight into its block
    (``attention.kv_local``), every head through ``write_block``."""
    for name, val in zip(names, (k, v)):
        dst = cache[name][i]
        spec = _kv_spec(cspecs, name)
        if ctx is None or attn.kv_local(cfg, ctx, spec):
            dst[:, offset:offset + val.shape[1]] = val
        else:
            par.write_block(ctx, dst, val.to(dst.dtype), (0, offset, 0, 0), spec)


# ===========================================================================
# Forward (prefill) and decode
# ===========================================================================


def _put(ctx, cache: Cache, name: str, idx, val: torch.Tensor, cspecs) -> None:
    """Store a layer's recurrent state or carry: straight where it has the
    block's shape (the rank's heads, or no mesh), else the rank's block of
    the whole value."""
    dst = cache[name][idx]
    if tuple(val.shape) == tuple(dst.shape):
        dst.copy_(val)
    else:
        spec = (None,) + tuple(cspecs[name][cspecs[name].__len__() - val.dim() + 1:])
        par.write_block(ctx, dst, val.to(dst.dtype), (0,) * val.dim(), spec)


def _get(ctx, cache: Cache, name: str, idx, cspecs) -> torch.Tensor:
    """A layer's carry whole (gathered over tp from the rank's block)."""
    blk = cache[name][idx]
    if ctx is None:
        return blk
    spec = (None,) + tuple(cspecs[name][len(cspecs[name]) - blk.dim() + 1:])
    return shd.gather_leaf(blk, spec, ctx.mesh)


def _dense_layer(cfg, p: Params, x: torch.Tensor, cos, sin, use_kernels: bool, ctx=None,
                 spec=None, kv_spec=None):
    """One dense or moe layer (attention + MLP/MoE) over a sequence.
    Returns (x, k, v, aux or None). Under sequence parallelism x is the
    rank's sequence block (``par.sublayer``); k and v cover the sequence."""
    h, (k, v) = par.sublayer(
        ctx, lambda xn: attn.attention_seq(cfg, p["attn"], xn, cos, sin,
                                           use_kernels=use_kernels, ctx=ctx,
                                           spec=None if spec is None else spec["attn"],
                                           kv_spec=kv_spec),
        par.shard_norm(ctx, cfg, p, "ln1", x))
    x = x + h
    y, aux = par.sublayer(ctx, lambda xn: _ffn_block(cfg, p, xn, ctx, spec),
                          par.shard_norm(ctx, cfg, p, "ln2", x))
    return x + y, k, v, aux


def _rwkv_layer(cfg, p: Params, x: torch.Tensor, use_kernels: bool, ctx, spec):
    """One rwkv6 layer from a zero state: (x, state, time-mix shift,
    channel-mix shift)."""
    y, st, sh_tm = par.sublayer(
        ctx, lambda xn: rwkv_mod.rwkv_time_mix(cfg, p["rwkv"], xn, None,
                                               use_kernels=use_kernels, ctx=ctx, spec=spec),
        par.shard_norm(ctx, cfg, p, "ln1", x))
    x = x + y
    y, sh_cm = par.sublayer(
        ctx, lambda xn: rwkv_mod.rwkv_channel_mix(cfg, p["rwkv"], xn, None, ctx=ctx, spec=spec),
        par.shard_norm(ctx, cfg, p, "ln2", x))
    return x + y, st, sh_tm, sh_cm


def _mamba_layer(cfg, p: Params, x: torch.Tensor, use_kernels: bool, ctx, spec):
    """One zamba2 mamba layer from a zero state: (x, state, conv carry)."""
    y, st, cv = par.sublayer(
        ctx, lambda xn: mam.mamba_forward(cfg, p["mamba"], xn, None, use_kernels=use_kernels,
                                          ctx=ctx, spec=spec),
        par.shard_norm(ctx, cfg, p, "ln1", x))
    return x + y, st, cv


def _sub(specs, key):
    return None if specs is None else specs[key]


def forward(
    cfg,
    params: Params,
    tokens: Optional[torch.Tensor] = None,
    *,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    cache_len: Optional[int] = None,
    use_kernels: bool = True,
    ctx: Optional[ParallelCtx] = None,
    cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Full-sequence forward of ``tokens`` (B, S), or of the vlm stub
    frontend's ``embeds`` (B, S, D) with ``positions`` ((3, B, S) for
    M-RoPE); audio takes the decoder's ``tokens`` and the stub frontend's
    ``frames`` (B, T, D). Returns (logits (B, S, V), aux loss (fp32
    scalar), cache-or-None); the cache covers ``cache_len`` positions
    (default S) with S filled. The recurrent families start from a zero
    state (``lm.py:315-318`` and ``:387`` of the reference).
    ``use_kernels=False`` runs the training path (module docstring). Under
    a mesh (``ctx``) the inputs and results are the rank's rows. ``cache``
    (not audio): a cache of B rows to fill in place of a new one, which is
    returned (``want_cache`` is then implied)."""
    _check_family(cfg)
    _single_device(cfg, ctx)
    ctx, specs, top = _mesh(cfg, ctx, params)
    if cfg.family == "audio":
        if cache is not None:
            raise ValueError(f"{cfg.name}: the audio family builds its own cache")
        return _whisper_forward(cfg, params, top, tokens, frames, want_cache, cache_len,
                                use_kernels, ctx, specs)
    B, S = (tokens if embeds is None else embeds).shape[:2]
    lctx = par.seq_ctx(ctx, S)  # the layers' ctx: the stream sequence-sharded, or ctx
    x, pos = _embed_inputs(cfg, top, tokens, embeds, positions, lctx, specs)
    if cache is not None:
        cspecs = _into(cfg, ctx, cache, B, S)
    else:
        cache, cspecs = _new_cache(cfg, ctx, B, cache_len or S, x.device) if want_cache else (
            None, None)
    kvs = _kv_spec(cspecs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = par.shard_norm(lctx, cfg, top, "ln0", x)
        for i, (p, sp) in enumerate(_layers(ctx, cfg, params["blocks"],
                                            _sub(specs, "blocks"))):
            x, st, sh_tm, sh_cm = _remat(ctx, _rwkv_layer)(cfg, p, x, use_kernels, lctx,
                                                           _sub(sp, "rwkv"))
            if cache is not None:
                _put(ctx, cache, "ssm_state", i, st, cspecs)
                _put(ctx, cache, "shift_tm", i, sh_tm, cspecs)
                _put(ctx, cache, "shift_cm", i, sh_cm, cspecs)
    else:
        cos, sin = positions_for_rope(cfg, pos, cfg.head_dim)
        if cfg.family == "nemotron_h":
            x = _nemotron_forward(cfg, params["blocks"], x, cos, sin, use_kernels, cache)
        elif cfg.family == "hybrid":
            shared, sspec = top["shared_attn"], _sub(specs, "shared_attn")
            for g, (group, gspec) in enumerate(_layers(ctx, cfg, params["blocks"],
                                                       _sub(specs, "blocks"))):
                for i, p in enumerate(group):
                    x, st, cv = _remat(ctx, _mamba_layer)(
                        cfg, p, x, use_kernels, lctx, None if gspec is None else gspec[i]["mamba"])
                    if cache is not None:
                        _put(ctx, cache, "ssm_state", (g, i), st, cspecs)
                        _put(ctx, cache, "conv", (g, i), cv, cspecs)
                x, k, v, a = _remat(ctx, _dense_layer)(cfg, shared, x, cos, sin, use_kernels,
                                                       lctx, sspec, kvs)
                aux = aux if a is None else aux + a
                if cache is not None:
                    _store_kv(cfg, ctx, cache, g, k, v, cspecs)
        else:
            for i, (p, sp) in enumerate(_layers(ctx, cfg, params["blocks"],
                                                _sub(specs, "blocks"))):
                x, k, v, a = _remat(ctx, _dense_layer)(cfg, p, x, cos, sin, use_kernels, lctx,
                                                       sp, kvs)
                aux = aux if a is None else aux + a
                if cache is not None:
                    _store_kv(cfg, ctx, cache, i, k, v, cspecs)
    if cache is not None:
        _set_length(cache, S)
    return _logits(cfg, top, par.seq_gather(lctx, x), ctx, specs), aux, cache


def _nemotron_forward(cfg, blocks, x: torch.Tensor, cos, sin, use_kernels: bool,
                      cache: Optional[Cache]) -> torch.Tensor:
    """nemotron_h's layers over a sequence, each ``x + mixer(RMSNorm(x))``,
    the Mamba-2 mixers from a zero state, each in a ``model.mamba`` span;
    the states, conv carries and K/V go into ``cache`` where one is given."""
    m = a = 0
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), blocks)):
        h = apply_norm(cfg, p, "ln1", x)
        if kind == MAMBA:
            with trace_span(SPAN_MODEL_MAMBA, layer=i):
                y, st, cv = mam.mamba_forward(cfg, p["mamba"], h, use_kernels=use_kernels)
            if cache is not None:
                cache["ssm_state"][m].copy_(st)
                cache["conv"][m].copy_(cv)
            m += 1
        elif kind == ATTN:
            y, (k, v) = attn.attention_seq(cfg, p["attn"], h, cos, sin, use_kernels=use_kernels)
            if cache is not None:
                _store_kv(cfg, None, cache, a, k, v, None)
            a += 1
        else:
            y = mlp_forward(cfg, p["mlp"], h)
        x = x + y
    return x


def _whisper_forward(cfg, params: Params, top: Params, tokens, frames, want_cache, cache_len,
                     use_kernels, ctx, specs):
    """Encoder over the stub frames (sinusoidal positions, bidirectional
    attention), then the decoder over ``tokens`` (learned positions,
    causal self-attention, cross-attention to the encoder output)."""
    if frames is None or tokens is None:
        raise ValueError(f"{cfg.name}: the audio family takes frames (B, T, D) and tokens")
    _check_ids(cfg, tokens)
    dt = dtype_of(cfg.dtype)
    frames = frames.to(dt)
    B, T, _ = frames.shape
    S = tokens.shape[1]
    # sinusoidal encoder positions, in fp32 as the reference forms them
    half = cfg.d_model // 2
    step = torch.log(torch.tensor(10_000.0)) / (half - 1)
    freq = torch.exp(-torch.arange(half, dtype=torch.float32) * step).to(frames.device)
    ang = torch.arange(T, dtype=torch.float32, device=frames.device)[:, None] * freq
    x = frames + torch.cat([torch.sin(ang), torch.cos(ang)], -1)[None].to(dt)
    for p, sp in _layers(ctx, cfg, params["enc_blocks"], _sub(specs, "enc_blocks")):
        x = _remat(ctx, _enc_layer)(cfg, p, x, use_kernels, ctx, sp)
    enc_out = apply_norm(cfg, top, "enc_final", x)

    x = _embed(cfg, top, tokens, ctx, _sub(specs, "embed")) + top["dec_pos"][:S][None].to(dt)
    cache, cspecs = (_new_cache(cfg, ctx, B, cache_len or S, x.device, enc_len=T)
                     if want_cache else (None, None))
    kvs, cross_spec = _kv_spec(cspecs), _kv_spec(cspecs, "cross_k")
    for i, (p, sp) in enumerate(_layers(ctx, cfg, params["dec_blocks"],
                                        _sub(specs, "dec_blocks"))):
        x, k, v, ck, cv = _remat(ctx, _dec_layer)(cfg, p, x, enc_out, use_kernels, ctx, sp,
                                                  kvs, cross_spec)
        if cache is not None:
            _store_kv(cfg, ctx, cache, i, k, v, cspecs)
            _store_kv(cfg, ctx, cache, i, ck, cv, cspecs, names=("cross_k", "cross_v"))
    if cache is not None:
        cache["length"] = S
    return (_logits(cfg, top, x, ctx, specs),
            torch.zeros((), dtype=torch.float32, device=x.device), cache)


def _enc_layer(cfg, p: Params, x: torch.Tensor, use_kernels: bool, ctx, sp):
    """One whisper encoder layer (bidirectional self-attention, MLP)."""
    h, _ = attn.attention_seq(cfg, p["attn"], apply_norm(cfg, p, "ln1", x), None, None,
                              causal=False, use_kernels=use_kernels, ctx=ctx,
                              spec=_sub(sp, "attn"))
    x = x + h
    return x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p, "ln2", x), ctx, _sub(sp, "mlp"))


def _dec_layer(cfg, p: Params, x: torch.Tensor, enc_out: torch.Tensor, use_kernels: bool,
               ctx, sp, kvs, cross_spec):
    """One whisper decoder layer: (x, self K, self V, cross K, cross V)."""
    h, (k, v) = attn.attention_seq(cfg, p["attn"], apply_norm(cfg, p, "ln1", x), None, None,
                                   use_kernels=use_kernels, ctx=ctx, spec=_sub(sp, "attn"),
                                   kv_spec=kvs)
    x = x + h
    ck, cv = attn.cross_attention_kv(cfg, p["cross"], enc_out, ctx=ctx,
                                     spec=_sub(sp, "cross"), kv_spec=cross_spec)
    x = x + attn.cross_attention(cfg, p["cross"], apply_norm(cfg, p, "ln2", x), ck, cv,
                                 ctx=ctx, spec=_sub(sp, "cross"), kv_spec=cross_spec)
    x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p, "ln3", x), ctx, _sub(sp, "mlp"))
    return x, k, v, ck, cv


def prefill(cfg, params: Params, tokens: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None, ctx: Optional[ParallelCtx] = None,
            cache: Optional[Cache] = None, **inputs) -> Tuple[torch.Tensor, Cache]:
    """``forward`` with the cache, on the kernels; ``inputs`` are its
    ``embeds``, ``positions`` and ``frames``; ``cache`` one to fill in place
    of a new one. Returns (logits, cache)."""
    logits, _, cache = forward(cfg, params, tokens, want_cache=True, cache_len=cache_len,
                               ctx=ctx, cache=cache, **inputs)
    return logits, cache


def prefill_extend(cfg, params: Params, tokens: torch.Tensor, prefix_k: torch.Tensor,
                   prefix_v: torch.Tensor, prefix_len: int,
                   cache_len: Optional[int] = None,
                   ctx: Optional[ParallelCtx] = None,
                   cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Prefill ONLY a suffix against an already-built prefix KV.

    The suffix tokens (B, S) run at positions ``[prefix_len, prefix_len +
    S)``, attending over the prefix K/V plus themselves causally; the
    returned cache is the dense cache a full ``prefill`` of prefix + suffix
    builds (prefix K/V copied into place, ``cache_len`` positions, default
    prefix_len + S), so ``decode_step`` continues from it; with ``cache``
    that cache is filled and returned instead.

    prefix_k/v: (L, B, Sp, Hkv, hd) post-RoPE (Sp >= prefix_len; the
    overhang is page padding). Families that carry recurrent state can't
    re-enter a stored prefix mid-stream: dense, moe and vlm only (vlm with
    text positions, replicated over M-RoPE's three streams).

    Under a mesh (``ctx``) the tokens are the rank's rows, prefix_k/v the
    rank's block of the pooled prefix (``parallel.prefix_spec``: kv heads,
    else head dim, over tp), and the cache the rank's block with
    ``max_len``, as ``prefill`` builds it; the moe layers run as in
    ``forward`` (mode "ep" through ``moe_forward_ep``), and sequence
    parallelism applies as there.
    """
    if cfg.family in ("audio", "ssm", "hybrid", "nemotron_h"):
        raise NotImplementedError(
            f"prefix extension requires a pure-KV cache; family "
            f"{cfg.family!r} carries recurrent state"
        )
    _check_family(cfg)
    _check_ids(cfg, tokens)
    ctx, specs, top = _mesh(cfg, ctx, params)
    B, S = tokens.shape
    lctx = par.seq_ctx(ctx, S)
    x = par.seq_shard(lctx, _embed(cfg, top, tokens, lctx, _sub(specs, "embed")))
    total = prefix_len + S
    M = cache_len or total
    if M < total and cache is None:
        raise ValueError(f"cache_len {M} < prefix_len + suffix {total}")
    pos = prefix_len + torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    cos, sin = positions_for_rope(cfg, pos, cfg.head_dim)
    if cache is not None:
        cspecs = _into(cfg, ctx, cache, B, total)
    else:
        cache, cspecs = _new_cache(cfg, ctx, B, M, x.device)
    kvs = _kv_spec(cspecs)
    pspec = None if ctx is None else par.prefix_spec(cfg, ctx)
    for i, (p, sp) in enumerate(_layers(ctx, cfg, params["blocks"], _sub(specs, "blocks"))):
        pk, pv = prefix_k[i], prefix_v[i]
        _put_prefix(ctx, cache, i, pk, pv, prefix_len, kvs, pspec)
        h, (k, v) = par.sublayer(
            lctx, lambda xn: attn.attention_extend(cfg, p["attn"], xn, cos, sin, pk, pv,
                                                   prefix_len, ctx=lctx, spec=_sub(sp, "attn"),
                                                   kv_spec=kvs, prefix_spec=pspec),
            par.shard_norm(lctx, cfg, p, "ln1", x))
        x = x + h
        x = x + par.sublayer(lctx, lambda xn: _ffn_block(cfg, p, xn, lctx, sp),
                             par.shard_norm(lctx, cfg, p, "ln2", x))[0]
        _store_kv(cfg, ctx, cache, i, k, v, cspecs, offset=prefix_len)
    _set_length(cache, total)
    return _logits(cfg, top, par.seq_gather(lctx, x), ctx, specs), cache


def _put_prefix(ctx, cache: Cache, i: int, pk, pv, prefix_len: int, kvs, pspec) -> None:
    """Copy layer i's pooled prefix (B, Sp, ...) positions [0, prefix_len)
    into the cache: straight where the cache's block has the pool's layout,
    else gathered whole and written into the block."""
    for name, val in (("kv_k", pk), ("kv_v", pv)):
        dst = cache[name][i]
        if ctx is None or tuple(kvs[1:]) == tuple(pspec[1:]):
            dst[:, :prefix_len] = val[:, :prefix_len]
        else:
            whole = shd.gather_leaf(val[:, :prefix_len], pspec, ctx.mesh)
            par.write_block(ctx, dst, whole.to(dst.dtype), (0, 0, 0, 0), kvs)


def prefix_of(cfg, cache: Cache, ctx: Optional[ParallelCtx] = None):
    """Batch row 0 of a dense cache's K and V, (L, M, Hkv, hd) each, in the
    prefix pool's layout: under a mesh the rank's block under
    ``parallel.prefix_spec`` (the cache's block where the layouts agree,
    else gathered over the cache's tp dims and the rank's block taken)."""
    if not par.active(ctx):
        return cache["kv_k"][:, 0], cache["kv_v"][:, 0]
    kvs = _kv_spec(_cache_specs(cfg, ctx, cache))
    pspec = par.prefix_spec(cfg, ctx)
    out = []
    for name in ("kv_k", "kv_v"):
        blk = cache[name][:, 0]  # (L, M', H', hd')
        if tuple(kvs[1:]) != tuple(pspec[1:]):
            blk = shd.gather_leaf(blk, (None,) + tuple(kvs[1:]), ctx.mesh)
            blk = shd.local_slice(blk, (None,) + tuple(pspec[1:]), ctx.mesh)
        out.append(blk)
    return out[0], out[1]


def decode_step(cfg, params: Params, cache: Cache, tokens: torch.Tensor,
                ctx: Optional[ParallelCtx] = None) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1) int. Every row decodes at the one
    shared position ``cache["length"]`` (the reference's semantics,
    lm.py:601-604): its K/V goes to slot ``min(length, M - 1)`` (the
    reference's clamp, attention.py:256) and every row attends over the
    slots up to it. The recurrent families step their state with plain
    PyTorch (``wkv6_step``), as the reference does, or, for Mamba-2, through
    ``ssd_step_op`` (in place on the card, where the state's copy into its
    cache slot is then a copy onto itself, which ``copy_`` skips); audio
    adds the learned position of ``length`` and attends over the cached
    cross K/V. Returns (logits (B, 1, V), cache) — the cache tensors are
    updated in place and returned with ``length + 1``. Without a mesh the
    position, the clamped slot and the rows' lengths are taken on the
    device from ``pos`` (made from ``length`` where the cache carries
    none), the K/V written with ``index_copy_``, and ``pos`` advanced in
    place: no launch is shaped by ``length``, so a CUDA graph can capture
    the step. Under a mesh the tokens, cache and logits are the rank's
    rows (module docstring), and the position is the host's ``length``."""
    _check_family(cfg)
    _single_device(cfg, ctx)
    ctx, specs, top = _mesh(cfg, ctx, params)
    cspecs = _cache_specs(cfg, ctx, cache)
    length = int(cache["length"])
    x = _embed(cfg, top, tokens, ctx, _sub(specs, "embed"))
    B = x.shape[0]
    blocks, bspecs = params.get("blocks"), None if specs is None else specs.get("blocks")
    if cfg.family == "ssm":
        x = apply_norm(cfg, top, "ln0", x)[:, 0]  # (B, D)
        for i, (p, sp) in enumerate(_layers(ctx, cfg, blocks, bspecs)):
            rs = _sub(sp, "rwkv")
            y, st, sh = rwkv_mod.rwkv_time_mix_step(
                cfg, p["rwkv"], apply_norm(cfg, p, "ln1", x), cache["ssm_state"][i],
                _get(ctx, cache, "shift_tm", i, cspecs), ctx=ctx, spec=rs)
            _put(ctx, cache, "ssm_state", i, st, cspecs)
            _put(ctx, cache, "shift_tm", i, sh, cspecs)
            x = x + y
            y, sh = rwkv_mod.rwkv_channel_mix(cfg, p["rwkv"], apply_norm(cfg, p, "ln2", x),
                                              _get(ctx, cache, "shift_cm", i, cspecs),
                                              ctx=ctx, spec=rs)
            _put(ctx, cache, "shift_cm", i, sh, cspecs)
            x = x + y
        return _logits(cfg, top, x[:, None], ctx, specs), dict(cache, length=length + 1)
    if ctx is not None:  # the rank's write of the new K/V takes the position on the host
        M = cache["max_len"]
        pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
        slot = min(length, M - 1)
        lengths = torch.full((B,), slot + 1, dtype=torch.int32, device=x.device)
    else:  # the position on the device: no launch depends on a host value
        M = cache["kv_k"].shape[2]
        at = cache.get("pos")
        if at is None:
            at = torch.full((), length, dtype=torch.int32, device=x.device)
        pos = at.expand(B, 1)
        last = at.clamp(max=M - 1)
        slot = last.reshape(1).long()  # the write's index (index_copy_ on the positions)
        lengths = (last + 1).expand(B)
    cos, sin = positions_for_rope(cfg, pos, cfg.head_dim)
    kvs = _kv_spec(cspecs)

    def self_attn(p, sp, x, i):
        return x + attn.attention_decode(cfg, p["attn"], apply_norm(cfg, p, "ln1", x), cos,
                                         sin, cache["kv_k"][i], cache["kv_v"][i], slot,
                                         lengths, ctx, _sub(sp, "attn"), kvs)

    def dense_layer(p, sp, x, i):
        x = self_attn(p, sp, x, i)
        return x + _ffn_block(cfg, p, apply_norm(cfg, p, "ln2", x), ctx, sp)[0]

    if cfg.family == "audio":
        rows = top["dec_pos"].shape[0]
        x = x + top["dec_pos"][min(length, rows - 1)].to(x.dtype)
        cross_spec = _kv_spec(cspecs, "cross_k")
        for i, (p, sp) in enumerate(_layers(ctx, cfg, params["dec_blocks"],
                                            _sub(specs, "dec_blocks"))):
            x = self_attn(p, sp, x, i)
            x = x + attn.cross_attention(cfg, p["cross"], apply_norm(cfg, p, "ln2", x),
                                         cache["cross_k"][i], cache["cross_v"][i], ctx=ctx,
                                         spec=_sub(sp, "cross"), kv_spec=cross_spec,
                                         block=True)
            x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p, "ln3", x), ctx,
                                _sub(sp, "mlp"))
    elif cfg.family == "nemotron_h":
        m = a = 0
        for kind, p in zip(layer_kinds(cfg), blocks):
            h = apply_norm(cfg, p, "ln1", x)
            if kind == MAMBA:
                y, st, cv = mam.mamba_step(cfg, p["mamba"], h[:, 0], cache["ssm_state"][m],
                                           cache["conv"][m])
                cache["ssm_state"][m].copy_(st)
                cache["conv"][m].copy_(cv)
                y, m = y[:, None], m + 1
            elif kind == ATTN:
                y = attn.attention_decode(cfg, p["attn"], h, cos, sin, cache["kv_k"][a],
                                          cache["kv_v"][a], slot, lengths)
                a += 1
            else:
                y = mlp_forward(cfg, p["mlp"], h)
            x = x + y
    elif cfg.family == "hybrid":
        x = x[:, 0]
        for g, (group, gspec) in enumerate(_layers(ctx, cfg, blocks, bspecs)):
            for i, p in enumerate(group):
                y, st, cv = mam.mamba_step(cfg, p["mamba"], apply_norm(cfg, p, "ln1", x),
                                           cache["ssm_state"][g, i],
                                           _get(ctx, cache, "conv", (g, i), cspecs), ctx=ctx,
                                           spec=None if gspec is None else gspec[i]["mamba"])
                _put(ctx, cache, "ssm_state", (g, i), st, cspecs)
                _put(ctx, cache, "conv", (g, i), cv, cspecs)
                x = x + y
            x = dense_layer(top["shared_attn"], _sub(specs, "shared_attn"), x[:, None], g)[:, 0]
        x = x[:, None]
    else:
        for i, (p, sp) in enumerate(_layers(ctx, cfg, blocks, bspecs)):
            x = dense_layer(p, sp, x, i)
    if "pos" in cache:
        cache["pos"].add_(1)
    return _logits(cfg, top, x, ctx, specs), dict(cache, length=length + 1)
