"""Mamba2 (SSD, state space duality) mixer, Zamba2-style (the port of
``repro.models.mamba``), and Nemotron-H's, whose B/C come in groups.

Recurrence (per head h, head_dim p, state s; B/C of the head's group g =
h // (heads / n_groups), shared by every head where n_groups = 1, as in
the reference):
    a_t = exp(-dt_t * exp(A_log_h))              scalar decay per head
    H_t = a_t H_{t-1} + (dt_t x_t) B_{g,t}^T     H: (P, S_state)
    y_t = H_t C_{g,t} + D_h x_t
then y * silu(z), an RMSNorm over each group's d_in / n_groups channels
(all of d_in with one group; Nemotron-H's ``norm_before_gate=False``) at
``cfg.norm_eps`` (the reference's 1e-6 where unset), and ``out_proj``.

A prefill runs the conv (with its bias and SiLU) through
``kernels.ops.causal_conv_op`` and the scan through ``kernels.ops.ssd_op``:
the hand-written CUDA kernels on a CUDA tensor, the plain conv
``ref.causal_conv_ref`` and the chunked plain scan on a CPU tensor.
Training (``use_kernels=False``) calls the plain conv (``_causal_conv``,
the reference's name) and the chunked form itself, ``ref.ssd_chunked_ref``,
the twin of the reference's model function ``ssd_chunked`` that the
reference trains through, with autograd. A decode
step runs through ``kernels.ops.ssd_step_op``: on a CUDA tensor a kernel
that updates the state in place, on a CPU tensor the plain ``ssd_step``
(the reference's), which returns a new state.

Under a mesh (``ctx`` and the layer's weight ``spec``; ``models/parallel.py``)
the concatenated ``in_proj`` (z, x, B, C, dt) is column-split over tp at no
head boundary, so its output is all-gathered over tp and each rank takes
its heads' z, x and dt (B and C are shared by every head); the depthwise
conv runs whole (its split weights gathered), the scan on the rank's heads
(the kernel at the local head count), the gated RMSNorm over d_in sums its
squares over tp, and ``out_proj``'s row shard ends in a ``psum``. The heads
must split evenly, and the mixer has one group there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh_compat as mc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import parallel as par
from repro_torch.models.common import Params, dense_init, dtype_of, rms_norm


def mamba_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.state_dim  # conv over (x, B, C)
    if heads % s.n_groups:
        raise ValueError(f"{cfg.name}: {s.n_groups} B/C groups do not divide {heads} heads")
    return d_in, heads, conv_ch


def mamba_init(cfg, generator, device) -> Params:
    """The reference's distributions and dtypes: the projections at 0.02 in
    ``param_dtype``, the conv weights at 0.1 in fp32, A_log 0 (A = -1),
    dt_bias -2, D 1. B and C take ``n_groups * state_dim`` columns each."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, heads, conv_ch = mamba_dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    # in_proj -> [z (d_in), x (d_in), B (groups x state), C (groups x state), dt (heads)]
    return {
        "in_proj": dense_init(generator, (d, d_in + conv_ch + heads), dt, device),
        "conv_w": dense_init(generator, (s.conv_dim, conv_ch), f32, device, scale=0.1),
        "conv_b": torch.zeros(conv_ch, dtype=f32, device=device),
        "A_log": torch.zeros(heads, dtype=f32, device=device),
        "dt_bias": torch.full((heads,), -2.0, dtype=f32, device=device),
        "D": torch.ones(heads, dtype=f32, device=device),
        "norm_scale": torch.ones(d_in, dtype=f32, device=device),
        "out_proj": dense_init(generator, (d_in, d), dt, device),
    }


# the reference's name for the plain conv (training's, and the op's on the CPU)
_causal_conv = ref.causal_conv_ref


def ssd_chunked(x, dt, A_log, B_, C_, D, state0, chunk: int = 128):
    """The reference's chunked scan under its name and signature:
    ``ref.ssd_chunked_ref`` from ``state0`` (B, H, P, Ns) -> (y, state)."""
    return ref.ssd_chunked_ref(x, dt, A_log, B_, C_, D, state0, chunk=chunk)


def ssd_step(x, dt, A_log, B_, C_, D, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step. x: (B, H, P); dt: (B, H); B_/C_: (B, Ns), shared by every
    head, or (B, G, Ns), head h reading group h // (H / G); state: (B, H,
    P, Ns) fp32 -> (y (B, H, P) fp32, new state)."""
    x = x.float()
    a = torch.exp(-dt.float() * torch.exp(A_log.float()))  # (B, H)
    dtx = x * dt[..., None]
    if B_.dim() == 3:  # groups: the heads' axis split as (G, H / G)
        Bb, G = B_.shape[:2]
        grouped = (Bb, G, x.shape[1] // G) + tuple(state.shape[2:])
        st = (a[..., None, None] * state).view(grouped) + (
            dtx.view(grouped[:4])[..., None] * B_.float()[:, :, None, None, :])
        y = torch.einsum("bghps,bgs->bghp", st, C_.float()).reshape(x.shape)
        return y + D[None, :, None] * x, st.view(state.shape)
    state = a[..., None, None] * state + dtx[..., None] * B_.float()[:, None, None, :]
    y = torch.einsum("bhps,bs->bhp", state, C_.float()) + D[None, :, None] * x
    return y, state


def _split_proj(cfg, proj):
    """in_proj output -> (z, x B C for the conv, dt_raw)."""
    d_in, _, conv_ch = mamba_dims(cfg)
    return proj[..., :d_in], proj[..., d_in:d_in + conv_ch], proj[..., d_in + conv_ch:]


def _scan_bc(cfg, conv_out):
    """The conv output's B and C: (..., Ns) each with one group, else
    (..., G, Ns)."""
    s = cfg.ssm
    d_in, _, _ = mamba_dims(cfg)
    n = s.n_groups * s.state_dim
    Bc, Cc = conv_out[..., d_in:d_in + n], conv_out[..., d_in + n:]
    if s.n_groups == 1:
        return Bc, Cc
    return (Bc.unflatten(-1, (s.n_groups, s.state_dim)),
            Cc.unflatten(-1, (s.n_groups, s.state_dim)))


def _gated_norm(cfg, p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """RMSNorm(y * silu(z)) over each group's d_in / n_groups channels (all
    of d_in with one group), at ``cfg.norm_eps`` where set, else the
    reference's 1e-6; y taken to z's dtype first."""
    h = y.to(z.dtype) * F.silu(z)
    G = cfg.ssm.n_groups
    eps = {} if cfg.norm_eps is None else {"eps": cfg.norm_eps}
    if G == 1:
        return rms_norm(h, p["norm_scale"], **eps)
    gs = h.shape[-1] // G
    return rms_norm(h.unflatten(-1, (G, gs)), p["norm_scale"].view(G, gs), **eps).flatten(-2)


def _tp(ctx, spec) -> bool:
    return par.active(ctx) and par.on_tp(ctx, spec["in_proj"][-1])


class _TP:
    """The rank's share of one mamba2 layer under tp: the whole in_proj
    output and conv weights, its heads [h0, h1) and channels [c0, c1)."""

    def __init__(self, cfg, p: Params, spec, x, ctx):
        d_in, heads, _ = mamba_dims(cfg)
        if cfg.ssm.n_groups != 1:
            raise NotImplementedError(f"{cfg.name}: B/C groups under tp")
        lh = par.local_heads(ctx, heads)
        if lh is None:
            raise NotImplementedError(f"{cfg.name}: {heads} mamba2 heads do not split over "
                                      f"{ctx.tp_size} tp ranks")
        self.ctx, self.h0, self.h1 = ctx, lh[0], lh[1]
        P = cfg.ssm.head_dim
        self.c0, self.c1 = self.h0 * P, self.h1 * P
        self.proj = mc.all_gather(par.fan_out(ctx, x) @ p["in_proj"], ctx.mesh, ctx.tp,
                                  dim=-1, grad="slice")
        self.conv_w = self.whole(p["conv_w"], spec["conv_w"])
        self.conv_b = self.whole(p["conv_b"], spec["conv_b"])

    def whole(self, w, spec):
        ctx = self.ctx
        if par.on_tp(ctx, spec[-1]):
            return mc.all_gather(w, ctx.mesh, ctx.tp, dim=-1, grad="slice")
        return w

    def mine(self, x, lo, hi):
        """Channels [lo, hi) of a replicated value, for rank-specific use."""
        return par.fan_out(self.ctx, x)[..., lo:hi]

    def scan_inputs(self, cfg, p, conv_out, dt_raw):
        s = cfg.ssm
        d_in, _, _ = mamba_dims(cfg)
        co = par.fan_out(self.ctx, conv_out)
        xin = co[..., self.c0:self.c1]
        Bc = co[..., d_in:d_in + s.state_dim]
        Cc = co[..., d_in + s.state_dim:]
        dt = F.softplus(self.mine(dt_raw.float(), self.h0, self.h1)
                        + self.mine(p["dt_bias"], self.h0, self.h1))
        A_log = self.mine(p["A_log"], self.h0, self.h1)
        D = self.mine(p["D"], self.h0, self.h1)
        return xin, Bc, Cc, dt, A_log, D

    def out(self, p, y, z, x_dtype):
        """Gated RMSNorm over the whole d_in (the squares summed over tp),
        then out_proj's row shard and a ``psum``."""
        ctx = self.ctx
        h = (y.to(x_dtype) * F.silu(self.mine(z, self.c0, self.c1))).float()
        d_in = z.shape[-1]
        # the whole sum of squares is used by each rank on its own channels:
        # fanned out, so each rank's partial sum gets the whole cotangent
        ss = par.fan_out(ctx, mc.psum(h.square().sum(dim=-1, keepdim=True), ctx.mesh, ctx.tp))
        h = (h * torch.rsqrt(ss / d_in + 1e-6) * p["norm_scale"].float()).to(x_dtype)
        return par.reduce_out(ctx, h @ p["out_proj"])


def mamba_forward(cfg, p: Params, x: torch.Tensor,
                  conv_prev: Optional[torch.Tensor] = None, *, use_kernels: bool = True,
                  ctx=None, spec=None):
    """x: (B, S, D). The conv runs on the causal_conv kernel and the scan,
    from a zero state, on the ssd kernel (``use_kernels``), or the plain conv
    and the chunked form. Returns (y, state (B, H, P, Ns)
    fp32, conv carry (B, K-1, CH)); under a mesh the state is the rank's
    heads', the conv carry whole."""
    B, S, D = x.shape
    s = cfg.ssm
    d_in, heads, _ = mamba_dims(cfg)
    conv = kops.causal_conv_op if use_kernels else _causal_conv
    scan = kops.ssd_op if use_kernels else ref.ssd_chunked_ref
    if _tp(ctx, spec):
        tp = _TP(cfg, p, spec, x, ctx)
        z, conv_in, dt_raw = _split_proj(cfg, tp.proj)
        conv_out, conv_carry = conv(conv_in, tp.conv_w, tp.conv_b, conv_prev)
        xin, Bc, Cc, dt, A_log, Dh = tp.scan_inputs(cfg, p, conv_out, dt_raw)
        y, state = scan(xin.reshape(B, S, tp.h1 - tp.h0, s.head_dim), dt, A_log, Bc, Cc, Dh,
                        chunk=s.chunk_size)
        return tp.out(p, y.reshape(B, S, -1), z, x.dtype), state, conv_carry
    z, conv_in, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    conv_out, conv_carry = conv(conv_in, p["conv_w"], p["conv_b"], conv_prev)
    xin = conv_out[..., :d_in]
    Bc, Cc = _scan_bc(cfg, conv_out)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    y, state = scan(xin.reshape(B, S, heads, s.head_dim), dt, p["A_log"], Bc, Cc, p["D"],
                    chunk=s.chunk_size)
    y = _gated_norm(cfg, p, y.reshape(B, S, d_in), z)
    return y @ p["out_proj"], state, conv_carry


def mamba_step(cfg, p: Params, x: torch.Tensor, state: torch.Tensor,
               conv_prev: torch.Tensor, *, ctx=None, spec=None):
    """Decode step. x: (B, D); conv_prev: (B, K-1, CH) whole. Returns (y (B,
    D), state, new conv carry); under a mesh ``state`` is the rank's heads'.
    On the card the returned state is ``state``, updated in place."""
    B, D = x.shape
    s = cfg.ssm
    d_in, heads, _ = mamba_dims(cfg)
    tp = _TP(cfg, p, spec, x, ctx) if _tp(ctx, spec) else None
    conv_w, conv_b = (p["conv_w"], p["conv_b"]) if tp is None else (tp.conv_w, tp.conv_b)
    z, conv_in, dt_raw = _split_proj(cfg, x @ p["in_proj"] if tp is None else tp.proj)
    window = torch.cat([conv_prev.to(conv_in.dtype), conv_in[:, None]], dim=1)  # (B, K, CH)
    conv_out = (window.float() * conv_w[None]).sum(dim=1)
    conv_out = F.silu(conv_out + conv_b).to(x.dtype)
    if tp is not None:
        xin, Bc, Cc, dt, A_log, Dh = tp.scan_inputs(cfg, p, conv_out, dt_raw)
        y, state = kops.ssd_step_op(xin.reshape(B, tp.h1 - tp.h0, s.head_dim), dt, A_log, Bc,
                                    Cc, Dh, state)
        return tp.out(p, y.reshape(B, -1), z, x.dtype), state, window[:, 1:]
    xin = conv_out[..., :d_in]
    Bc, Cc = _scan_bc(cfg, conv_out)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, H)
    y, state = kops.ssd_step_op(xin.reshape(B, heads, s.head_dim), dt, p["A_log"], Bc, Cc,
                                p["D"], state)
    y = _gated_norm(cfg, p, y.reshape(B, d_in), z)
    return y @ p["out_proj"], state, window[:, 1:]
