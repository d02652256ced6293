"""RWKV6 ("Finch") blocks: time-mix with data-dependent decay + channel-mix
(the port of ``repro.models.rwkv``).

Recurrence (per head, key dim n, value dim m):
    y_t = r_t^T (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with w_t = exp(-exp(w_base + lora(x^w_t))) in (0, 1), data-dependent.

A prefill runs the recurrence through ``kernels.ops.wkv6_op``: the
hand-written CUDA kernel on a CUDA tensor, the chunked plain version on a
CPU tensor. Training (``use_kernels=False``) calls the chunked form itself,
``ref.wkv6_chunked_ref``, the twin of the reference's model function
``wkv6_chunked`` that the reference trains through, with autograd. A decode
step is plain PyTorch (``wkv6_step``), as in the reference.

Under a mesh (``ctx`` and the layer's weight ``spec``; ``models/parallel.py``)
with r/k/v/g column-split over tp, each rank runs the recurrence on its
heads (the kernel at the local head count): its decay channels, bonus rows
and group-norm affine are slices of the whole ones, and ``wo``'s row shard
ends in a ``psum``. Where the heads do not split evenly over tp
(rwkv6-3b's 40 over 16), every rank runs every head, and ``wo``'s row shard
takes the rank's rows of the whole output before the ``psum``. The channel
mix is Megatron's column / row pair for ``ck``/``cv``, with ``cr``'s column
shard all-gathered. The shift carries stay whole (the layer input is
replicated).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh_compat as mc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import parallel as par
from repro_torch.models.common import Params, dense_init, dtype_of, layer_norm, token_shift

LORA_DIM = 64


def rwkv_init(cfg, generator, device) -> Params:
    """The reference's distributions and dtypes: mixes 0.5, decay base -4.6
    (decay ~ exp(-0.01)), the decay LoRA at scale 0.01 and the bonus at 0.1
    in fp32, the projections at 0.02 in ``param_dtype``."""
    d = cfg.d_model
    s = cfg.ssm
    heads = d // s.head_dim
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32

    def full(value):
        return torch.full((d,), value, dtype=f32, device=device)

    def dense(shape, dtype=dt, scale=0.02):
        return dense_init(generator, shape, dtype, device, scale=scale)

    return {
        # time-mix
        "mix_r": full(0.5),
        "mix_k": full(0.5),
        "mix_v": full(0.5),
        "mix_g": full(0.5),
        "mix_w": full(0.5),
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        "w_base": full(-4.6),
        "w_lora_a": dense((d, LORA_DIM), f32, 0.01),
        "w_lora_b": dense((LORA_DIM, d), f32, 0.01),
        "bonus": dense((heads, s.head_dim), f32, 0.1),
        "ln_x_scale": full(1.0),
        "ln_x_bias": full(0.0),
        # channel-mix
        "mix_ck": full(0.5),
        "mix_cr": full(0.5),
        "ck": dense((d, cfg.d_ff)),
        "cv": dense((cfg.d_ff, d)),
        "cr": dense((d, d)),
    }


def wkv6_chunked(r, k, v, w_log, u, state0, chunk: int = 64):
    """The reference's chunked scan under its name and signature:
    ``ref.wkv6_chunked_ref`` from ``state0`` (B, H, N, N) -> (y, state)."""
    return ref.wkv6_chunked_ref(r, k, v, w_log, u, state0, chunk=chunk)


def wkv6_step(r, k, v, w_log, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. r, k, v, w_log: (B, H, N); u: (H, N); state:
    (B, H, N, N) fp32 -> (y (B, H, N) fp32, new state)."""
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(w_log.float())
    y = torch.einsum("bhn,bhnm->bhm", r, state)
    coef = (r * u[None] * k).sum(-1, keepdim=True)  # (B, H, 1)
    y = y + coef * v
    state = w[..., None] * state + k[..., None] * v[..., None, :]
    return y, state


def _ddlerp(x, x_shift, mix):
    return x + (x_shift - x) * mix.to(x.dtype)


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log decay (Finch): -exp(w_base + lora(xw)), clipped to
    [-8, -1e-5], in fp32."""
    lora = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.clamp(-torch.exp(p["w_base"] + lora), -8.0, -1e-5)


def _projections(p: Params, x, xs):
    """r, k, v, g and the log decay from x and its shifted copy."""
    xr = _ddlerp(x, xs, p["mix_r"])
    xk = _ddlerp(x, xs, p["mix_k"])
    xv = _ddlerp(x, xs, p["mix_v"])
    xg = _ddlerp(x, xs, p["mix_g"])
    xw = _ddlerp(x, xs, p["mix_w"])
    g = F.silu(xg @ p["wg"])
    return xr @ p["wr"], xk @ p["wk"], xv @ p["wv"], g, _decay(p, xw)


def _out(p: Params, y: torch.Tensor, g: torch.Tensor, x_dtype) -> torch.Tensor:
    """Per-head group norm of the fp32 y (..., H, N), affine, gate, output
    projection."""
    yh = layer_norm(y, None, None)
    y = yh.flatten(-2) * p["ln_x_scale"] + p["ln_x_bias"]
    return (y.to(x_dtype) * g) @ p["wo"]


def _tp(ctx, spec) -> bool:
    return par.active(ctx) and par.on_tp(ctx, spec["wr"][-1])


def _tp_heads(cfg, ctx) -> Tuple[int, int]:
    """[h0, h1) of the heads this rank runs: its tp share where they split
    evenly, else all of them."""
    H = cfg.d_model // cfg.ssm.head_dim
    return par.local_heads(ctx, H) or (0, H)


def _mine(ctx, t: torch.Tensor, lo: int, hi: int, whole: int, dim: int = -1) -> torch.Tensor:
    """[lo, hi) of ``dim`` of a replicated value, fanned out where it is the
    rank's own share of ``whole``; all of it is used alike on every rank."""
    if hi - lo == whole:
        return t
    return par.fan_out(ctx, t).narrow(dim, lo, hi - lo)


def _projections_tp(cfg, p: Params, spec, x, xs, ctx):
    """The rank's heads of r, k, v (..., Hl, N), its g (..., Hl * N) and
    its decay channels."""
    N = cfg.ssm.head_dim
    H = cfg.d_model // N
    h0, h1 = _tp_heads(cfg, ctx)
    want = list(range(h0, h1))
    mixed = [_ddlerp(x, xs, p[f"mix_{c}"]) for c in "rkvgw"]
    r, k, v, g = (par.heads(ctx, xm, p[w], None, spec[w], want, H, N)
                  for xm, w in zip(mixed, ("wr", "wk", "wv", "wg")))
    g = F.silu(g.flatten(-2))
    w_log = _mine(ctx, _decay(p, mixed[4]), h0 * N, h1 * N, H * N)
    return r, k, v, g, w_log.unflatten(-1, (h1 - h0, N)).contiguous(), (h0, h1)


def _out_tp(ctx, p: Params, spec, y, g, x_dtype, h01, N):
    """``_out`` on the rank's heads: its slice of the affine, then ``wo``'s
    row shard and a ``psum`` (every head run: the rank's rows of the whole
    output, as ``parallel.row_out``)."""
    h0, h1 = h01
    yh = layer_norm(y, None, None)
    D = p["ln_x_scale"].shape[-1]
    aff = (yh.flatten(-2) * _mine(ctx, p["ln_x_scale"], h0 * N, h1 * N, D)
           + _mine(ctx, p["ln_x_bias"], h0 * N, h1 * N, D))
    o = aff.to(x_dtype) * g
    wo = p["wo"]  # rows split over tp exactly where wr's columns are (both D % tp)
    if h1 - h0 != D // N:
        return par.reduce_out(ctx, o @ wo)
    lo = ctx.tp_index * wo.shape[0]
    return par.reduce_out(ctx, par.fan_out(ctx, o)[..., lo:lo + wo.shape[0]] @ wo)


def rwkv_time_mix(cfg, p: Params, x: torch.Tensor, x_prev: Optional[torch.Tensor], *,
                  use_kernels: bool = True, ctx=None,
                  spec=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D); x_prev: (B, D) shift carry or None. The recurrence
    starts from a zero state, on the wkv6 kernel (``use_kernels``) or the
    chunked form. Returns (y, state (B, H, N, N) fp32, new x_prev); under a
    mesh the state is the rank's heads'."""
    B, S, D = x.shape
    s = cfg.ssm
    H, N = D // s.head_dim, s.head_dim
    scan = kops.wkv6_op if use_kernels else ref.wkv6_chunked_ref
    if _tp(ctx, spec):
        r, k, v, g, w_log, h01 = _projections_tp(cfg, p, spec, x, token_shift(x, x_prev), ctx)
        u = _mine(ctx, p["bonus"], h01[0], h01[1], H, dim=0)
        y, state = scan(r, k, v, w_log, u, chunk=s.chunk_size)
        return _out_tp(ctx, p, spec, y, g, x.dtype, h01, N), state, x[:, -1]
    r, k, v, g, w_log = _projections(p, x, token_shift(x, x_prev))
    y, state = scan(r.reshape(B, S, H, N), k.reshape(B, S, H, N), v.reshape(B, S, H, N),
                    w_log.reshape(B, S, H, N), p["bonus"], chunk=s.chunk_size)
    return _out(p, y, g, x.dtype), state, x[:, -1]


def rwkv_time_mix_step(cfg, p: Params, x: torch.Tensor, state: torch.Tensor,
                       x_prev: torch.Tensor, *, ctx=None, spec=None):
    """Decode step. x: (B, D). Returns (y (B, D), state, new x_prev); under
    a mesh ``state`` is the rank's heads'."""
    B, D = x.shape
    s = cfg.ssm
    H, N = D // s.head_dim, s.head_dim
    if _tp(ctx, spec):
        r, k, v, g, w_log, h01 = _projections_tp(cfg, p, spec, x, x_prev, ctx)
        u = _mine(ctx, p["bonus"], h01[0], h01[1], H, dim=0)
        y, state = wkv6_step(r, k, v, w_log, u, state)
        return _out_tp(ctx, p, spec, y, g, x.dtype, h01, N), state, x
    r, k, v, g, w_log = _projections(p, x, x_prev)
    y, state = wkv6_step(r.reshape(B, H, N), k.reshape(B, H, N), v.reshape(B, H, N),
                         w_log.reshape(B, H, N), p["bonus"], state)
    return _out(p, y, g, x.dtype), state, x


def rwkv_channel_mix(cfg, p: Params, x: torch.Tensor, x_prev: Optional[torch.Tensor], *,
                     ctx=None, spec=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) (or (B, D) with x_prev for decode). Returns (y,
    new x_prev)."""
    xs = x_prev if x.dim() == 2 else token_shift(x, x_prev)
    xk = _ddlerp(x, xs, p["mix_ck"])
    xr = _ddlerp(x, xs, p["mix_cr"])
    carry = x if x.dim() == 2 else x[:, -1]
    if par.active(ctx):
        if par.on_tp(ctx, spec["cv"][0]):
            kk = torch.relu(par.fan_out(ctx, xk) @ p["ck"])
            val = mc.psum((kk * kk) @ p["cv"], ctx.mesh, ctx.tp)
        else:
            kk = torch.relu(xk @ p["ck"])
            val = (kk * kk) @ p["cv"]
        if par.on_tp(ctx, spec["cr"][-1]):
            gate = mc.all_gather(par.fan_out(ctx, xr) @ p["cr"], ctx.mesh, ctx.tp, dim=-1,
                                 grad="slice")
        else:
            gate = xr @ p["cr"]
        return torch.sigmoid(gate) * val, carry
    kk = torch.relu(xk @ p["ck"])
    y = torch.sigmoid(xr @ p["cr"]) * ((kk * kk) @ p["cv"])
    return y, carry
