"""The model under a mesh: ``ParallelCtx`` (the reference's
``lm.ParallelCtx``, re-exported by ``models/lm.py``) and the tensor-parallel
building blocks the forwards share.

Every rank runs the same program on its shards (SPMD): the batch split over
the dp axes, the weights as ``distributed.sharding.param_pspecs`` lays them
out. A layer's weights are gathered over their FSDP axes as the layer
starts (``gather_params``); the dims sharded over the tp axis stay local:

* ``heads``: a column-parallel projection to the heads this rank computes.
  Where the local columns are exactly those heads, ``x @ W_local``; where
  they are not (a shard inside a head, kv heads < tp), the projection is
  all-gathered over tp and the rank takes its heads; where the guard left
  the weight whole, the projection runs whole on each rank.
* ``row_out``: the row-parallel output projection and its ``psum``.

Gradient convention (``distributed/mesh_compat.py``): a value replicated
over a group carries the whole cotangent on each rank, so ``fan_out``
marks each place where such a value (activation or weight) enters a
computation that differs by rank, and ``psum`` passes cotangents through.

Sequence parallelism (``profile.seq_parallel``, Megatron's): in a forward
over S > 1 positions the residual stream between sublayers is the rank's
1/tp of the sequence (padded to a multiple of tp; ``seq_ctx``). Norms and
residual adds run on that shard; a sublayer's input is all-gathered over
the sequence (``seq_gather``: its backward takes the rank's block of the
whole cotangent the sublayer's ``fan_out``s build), and where the
sublayer ends in the row-parallel ``psum`` a reduce-scatter over the
sequence takes its place (``reduce_out``; backward an all-gather). A
sublayer whose output is replicated (weights the guard left whole, the
experts) gives the rank its block (``seq_shard``). Decode (S = 1) runs as
without it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ShardingProfile
from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import entry_axes
from repro_torch.models.common import apply_norm


@dataclass(frozen=True)
class ParallelCtx:
    """Mesh context threaded through forwards (None mesh = single device).
    ``profile`` is the layout the parameters were sharded by; the
    reference's ``tp_axis``, ``ep_axis``, ``remat`` and ``seq_parallel``
    are read from it. ``dp_axes``: the batch axes (``from_profile`` takes
    those of the profile the mesh has)."""

    mesh: Any = None
    dp_axes: Tuple[str, ...] = ("data",)
    profile: ShardingProfile = ShardingProfile()
    # the true sequence length while the residual stream is sequence-
    # sharded (a forward under seq_parallel; ``seq_ctx``), else 0
    seq_len: int = 0

    @classmethod
    def from_profile(cls, mesh, profile: ShardingProfile) -> "ParallelCtx":
        return cls(mesh=mesh, dp_axes=shd.dp_axes_for_mesh(mesh, profile), profile=profile)

    @property
    def tp_axis(self) -> str:
        return self.profile.tp_axis

    @property
    def ep_axis(self) -> str:
        return self.profile.ep_axis

    @property
    def remat(self) -> str:
        return self.profile.remat

    @property
    def seq_parallel(self) -> bool:
        return self.profile.seq_parallel

    @property
    def tp(self) -> str:
        """The tp axis if the mesh has it, else ''."""
        return self.tp_axis if self.tp_axis in self.mesh.axis_names else ""

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp) if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.axis_index(self.tp) if self.tp else 0

    @property
    def dp(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp_axes if a in self.mesh.axis_names)

    def param_specs(self, cfg) -> Any:
        """``param_pspecs`` of the full model under this layout (cached)."""
        key = (cfg, self.profile, tuple(self.mesh.axis_names), self.mesh.devices.shape)
        got = _SPECS.get(key)
        if got is None:
            from repro_torch.models.lm import abstract_params

            got = _SPECS[key] = shd.param_pspecs(abstract_params(cfg), self.profile, self.mesh)
        return got

    def cache_specs(self, cfg, batch: int, max_len: int, **kw) -> Any:
        from repro_torch.models.lm import abstract_cache

        return shd.cache_pspecs(abstract_cache(cfg, batch, max_len, **kw), cfg, self.profile,
                                self.mesh)


_SPECS: Dict[Any, Any] = {}


def active(ctx: Optional[ParallelCtx]) -> bool:
    return ctx is not None and ctx.mesh is not None


def on_tp(ctx: ParallelCtx, entry) -> bool:
    """Whether a spec entry shards its dim over the tp axis."""
    return bool(ctx.tp) and ctx.tp in entry_axes(entry)


# ---------------------------------------------------------------------------
# FSDP: gather a layer's weights
# ---------------------------------------------------------------------------


def gather_params(ctx: ParallelCtx, p: Any, spec: Any, keep: Sequence[str] = ()) -> Any:
    """``p`` with every sharded dim gathered, except those over the axes of
    ``keep``. Over dp axes the gradient is reduce-scattered back (FSDP:
    each rank used the weight on its own data); over others it is sliced
    (the weight was used replicated)."""
    if isinstance(p, dict):
        return {k: gather_params(ctx, v, spec[k], keep) for k, v in p.items()}
    if isinstance(p, list):
        return [gather_params(ctx, v, spec[i], keep) for i, v in enumerate(p)]
    if not isinstance(p, torch.Tensor):
        return p
    return shd.gather_leaf(p, spec, ctx.mesh, keep=tuple(keep), dp=tuple(ctx.dp_axes))


def gather_layer(ctx: ParallelCtx, cfg, p: Any, spec: Any) -> Any:
    """A layer's weights for its forward: FSDP dims gathered, tp dims kept;
    a moe's experts kept sharded over ep in mode "ep", gathered whole in
    mode "dense" (GShard dispatch runs every expert on each rank)."""
    keep = (ctx.tp,) if ctx.tp else ()
    if isinstance(p, dict) and "moe" in p:
        out = {k: gather_params(ctx, v, spec[k], keep) for k, v in p.items() if k != "moe"}
        ep = ctx.ep_axis if ctx.ep_axis in ctx.mesh.axis_names else ""
        out["moe"] = gather_params(ctx, p["moe"], spec["moe"],
                                   (ep,) if (cfg.moe.mode == "ep" and ep) else ())
        return out
    return gather_params(ctx, p, spec, keep)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def fan_out(ctx: ParallelCtx, x: torch.Tensor) -> torch.Tensor:
    return mc.fan_out(x, ctx.mesh, ctx.tp) if ctx.tp else x


def local_heads(ctx: ParallelCtx, n_heads: int) -> Optional[Tuple[int, int]]:
    """[lo, hi) of the heads this rank owns when they split over tp, else
    None (every rank computes all of them)."""
    T = ctx.tp_size
    if not ctx.tp or n_heads % T:
        return None
    n = n_heads // T
    return ctx.tp_index * n, (ctx.tp_index + 1) * n


def heads(ctx: ParallelCtx, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          w_spec, want: Sequence[int], n_heads: int, hd: int) -> torch.Tensor:
    """x (..., D) @ a column-parallel W, as the heads ``want`` (sorted
    global head ids): (..., len(want), hd)."""
    lead = x.shape[:-1]
    want = list(want)
    if on_tp(ctx, w_spec[-1]):
        r = ctx.tp_index
        cols = w.shape[-1]
        y = fan_out(ctx, x) @ w
        if b is not None:
            y = y + b
        if cols % hd == 0 and want == list(range(r * cols // hd, (r + 1) * cols // hd)):
            return y.reshape(*lead, len(want), hd)
        y = mc.all_gather(y, ctx.mesh, ctx.tp, dim=-1, grad="slice")  # (..., n_heads*hd)
    else:
        y = x @ w
        if b is not None:
            y = y + b
    y = y.reshape(*lead, n_heads, hd)
    if want == list(range(n_heads)):
        return y
    return fan_out(ctx, y)[..., want, :]


def row_out(ctx: ParallelCtx, o: torch.Tensor, wo: torch.Tensor, wo_spec,
            have: Sequence[int], n_heads: int, hd: int) -> torch.Tensor:
    """o (..., len(have), hd), the heads ``have``, through the row-parallel
    W_o (rows = n_heads * hd): the rank's rows, then ``psum`` over tp
    (``reduce_out``)."""
    lead = o.shape[:-2]
    o = o.reshape(*lead, len(have) * hd)
    if not on_tp(ctx, wo_spec[0]):  # whole W_o: whole heads on every rank
        return o @ wo
    if list(have) != list(range(n_heads)):  # the rank's heads: its rows of W_o
        return reduce_out(ctx, o @ wo)
    rows = wo.shape[0]
    lo = ctx.tp_index * rows
    return reduce_out(ctx, fan_out(ctx, o)[..., lo:lo + rows] @ wo)


def share_grad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Identity forward; the backward divides the cotangent by ``n`` (one
    value computed n times over, each copy taking its share)."""
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ShareGrad.apply(x, n)


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------


def seq_ctx(ctx: Optional[ParallelCtx], S: int) -> Optional[ParallelCtx]:
    """``ctx`` with the residual stream of an S-position forward sharded over
    the sequence, where the profile asks for it, the mesh has a tp axis of
    more than one rank and S > 1 (then a shard, ceil(S / tp) positions, is
    shorter than the sequence); else ``ctx`` itself."""
    if not active(ctx) or not ctx.seq_parallel or ctx.tp_size == 1 or S <= 1:
        return ctx
    return dataclasses.replace(ctx, seq_len=S)


def _padded(ctx: ParallelCtx, x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[1]) % ctx.tp_size
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)


def reduce_out(ctx: ParallelCtx, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel output's partial sums (B, S, ...) combined over tp: a
    ``psum``, or under sequence parallelism a reduce-scatter over the
    (padded) sequence, the rank's block of the sum."""
    if not ctx.seq_len:
        return mc.psum(y, ctx.mesh, ctx.tp)
    return mc.reduce_scatter(_padded(ctx, y), ctx.mesh, ctx.tp, dim=1)


def seq_shard(ctx: Optional[ParallelCtx], y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output as the rank's sequence block: already one where
    ``reduce_out`` scattered it (fewer positions than the sequence), else
    the block of the replicated whole; ``y`` itself without sequence
    parallelism."""
    if ctx is None or not ctx.seq_len or y.shape[1] != ctx.seq_len:
        return y
    return mc.scatter(_padded(ctx, y), ctx.mesh, ctx.tp, dim=1)


def seq_gather(ctx: Optional[ParallelCtx], x: torch.Tensor) -> torch.Tensor:
    """The whole sequence (trimmed to ``seq_len``) from each rank's block;
    ``x`` itself without sequence parallelism."""
    if ctx is None or not ctx.seq_len:
        return x
    return mc.all_gather(x, ctx.mesh, ctx.tp, dim=1, grad="slice")[:, :ctx.seq_len]


def shard_norm(ctx: Optional[ParallelCtx], cfg, p, name: str, x: torch.Tensor) -> torch.Tensor:
    """``apply_norm`` of the residual stream. Under sequence parallelism x
    is the rank's sequence block, so the norm's replicated weights enter a
    computation that differs by rank: fanned out (their gradients summed
    over tp, as Megatron all-reduces its sequence-parallel norms')."""
    if ctx is not None and ctx.seq_len:
        p = {k: fan_out(ctx, p[k]) for k in (f"{name}_scale", f"{name}_bias") if k in p}
    return apply_norm(cfg, p, name, x)


def sublayer(ctx: Optional[ParallelCtx], fn, x: torch.Tensor, *args, **kw):
    """``fn(x, ...)``'s first result as a residual-stream update: under
    sequence parallelism ``x`` (the shard) is gathered first and the result
    given back as the rank's block; other results pass through."""
    if ctx is None or not ctx.seq_len:
        return fn(x, *args, **kw)
    out = fn(seq_gather(ctx, x), *args, **kw)
    if isinstance(out, tuple):
        return (seq_shard(ctx, out[0]),) + tuple(out[1:])
    return seq_shard(ctx, out)


# ---------------------------------------------------------------------------
# The pooled KV prefix under a mesh
# ---------------------------------------------------------------------------


def prefix_spec(cfg, ctx: ParallelCtx):
    """The layout of a layer's pooled prefix K or V (B, Sp, Hkv, hd) under a
    mesh: the kv heads over tp where they split evenly, else the head dim,
    else whole (``cache_pspecs``'s rule without its sequence option: a page
    holds every position of its span on every rank)."""
    none = mc.P(None, None, None, None)
    if not ctx.tp:
        return none
    T = ctx.tp_size
    if cfg.num_kv_heads % T == 0:
        return mc.P(None, None, ctx.tp, None)
    if cfg.head_dim % T == 0:
        return mc.P(None, None, None, ctx.tp)
    return none


def prefix_dims(cfg, ctx: Optional[ParallelCtx]) -> Tuple[int, int]:
    """(kv heads, head dim) of the rank's pooled prefix (whole without a
    mesh)."""
    if not active(ctx):
        return cfg.num_kv_heads, cfg.head_dim
    spec = prefix_spec(cfg, ctx)
    T = ctx.tp_size
    return (cfg.num_kv_heads // (T if spec[2] else 1), cfg.head_dim // (T if spec[3] else 1))


# ---------------------------------------------------------------------------
# Blocks of a sharded tensor (the KV cache under a mesh)
# ---------------------------------------------------------------------------


def block_range(ctx: ParallelCtx, spec, d: int, size: int) -> Tuple[int, int]:
    """[lo, hi) of dim ``d`` (local extent ``size``) in whole coordinates."""
    axes = entry_axes(spec[d])
    if not axes:
        return 0, size
    i = ctx.mesh.axis_index(axes)
    return i * size, (i + 1) * size


def write_block(ctx: ParallelCtx, local: torch.Tensor, piece: torch.Tensor,
                offsets: Sequence[int], spec) -> None:
    """Write ``piece``, placed at ``offsets`` of the whole tensor, into the
    part of it this rank's block holds (in place)."""
    dst, src = [], []
    for d in range(local.dim()):
        lo, hi = block_range(ctx, spec, d, local.shape[d])
        a, b = offsets[d], offsets[d] + piece.shape[d]
        s, e = max(lo, a), min(hi, b)
        if s >= e:
            return
        dst.append(slice(s - lo, e - lo))
        src.append(slice(s - a, e - a))
    local[tuple(dst)] = piece[tuple(src)]
