"""The port's mesh surface: named mesh axes over ``torch.distributed`` process
groups, and the collectives along them (the counterpart of
``repro.distributed.mesh_compat``, which maps the modern jax mesh API onto
older jax; here the same names map onto torch).

* ``AbstractMesh(shape, axes)``: axis names and extents only, no process
  group and no device. The sharding rules and the production meshes use it.
* ``Mesh(shape, axes)``: a live mesh over an initialised process group.
  Ranks are laid out row-major over ``shape`` (rank = the linear index of
  its coordinates). For every non-empty set of axes the mesh holds one
  process group per line of ranks that differ only along those axes
  (``dist.new_group``, made once, collectively, when the mesh is built).
  ``ranks=`` builds a mesh over a subset of the world (a node lost, say);
  every rank of the world must build it, and those outside it hold a mesh
  with ``member`` False.

Both expose ``axis_names`` and ``devices.shape``, so code written for the
reference (``dict(zip(mesh.axis_names, mesh.devices.shape))``) runs on them
unchanged.

The collectives take ``(x, mesh, axes)``, ``axes`` one axis name or a tuple
of them (the group is then their product, row-major): ``psum``, ``pmean``,
``pmax``, ``all_gather``, ``all_to_all`` (tiled: split and concatenate on
dim 0, as ``jax.lax.all_to_all(..., tiled=True)``), ``ppermute`` and
``axis_index``. Every call goes through the backend, at extent 1 too.

The backend is the process group's: NCCL where each rank owns a card, gloo
on the CPU and for several ranks that share one card. Gloo reduces host
tensors; a CUDA operand is copied to the host, reduced there and copied
back (``Mesh.backend`` says which backend runs; ``staged_bytes`` counts
the copies: the operand to the host, the result back). ``COUNTERS[kind]``
holds ``calls``, ``bytes`` (the operand's bytes a call) and
``staged_bytes`` for each kind of collective; ``reset_counters()`` zeroes
them.

Inside a differentiated function the collectives are ``autograd.Function``s
with the transposes a sharded program needs (a value replicated over a
group carries the same, whole cotangent on each rank; a partial sum
carries its own):

* ``psum``: backward is the identity on each rank's share;
* ``all_gather``: backward is a reduce-scatter (``grad="scatter"``, the
  FSDP case: each rank used the gathered weight on its own data;
  ``reduce_scatter_tensor`` on either backend), or takes
  the rank's own slice (``grad="slice"``: the gathered value was used
  replicated, as the tensor-parallel logits are);
* ``ppermute``: backward is the reverse permutation;
* ``fan_out``: identity forward, ``psum`` backward: a replicated value
  entering a computation that differs by rank (Megatron's "f");
* ``reduce_scatter``: sum over the group, each rank keeping its block of a
  dim (partial sums in, a block of the sum out: sequence parallelism's
  row-parallel output); backward all-gathers the blocks' cotangents;
* ``scatter``: the rank's block of a dim of a replicated value, no
  communication; backward all-gathers the blocks' cotangents.

A mesh built with ``on_collective=fn`` calls ``fn(kind, nbytes, members)``
for each of its collectives, with the operand's bytes and the global ranks
of its group, in the order they run (the dry-run prices each collective by
its group's span).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

KINDS = ("psum", "pmax", "all_gather", "all_to_all", "ppermute", "reduce_scatter")
COUNTERS: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0, "staged_bytes": 0}
                                       for k in KINDS}


def reset_counters() -> None:
    for c in COUNTERS.values():
        for k in c:
            c[k] = 0


class P(tuple):
    """A partition spec: one entry a dimension, each an axis name, a tuple of
    axis names, or None (replicated). ``tuple(P(...))`` equals
    ``tuple(jax.sharding.PartitionSpec(...))`` for the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class _Devices:
    """Stands in for the reference mesh's device array: its ``shape``."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape
        self.size = int(np.prod(shape)) if shape else 1


class AbstractMesh:
    """Axis names and extents, no process group: for the sharding rules and
    the production meshes."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.axis_names = axes
        self.devices = _Devices(shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_size(self, axes: Axes) -> int:
        n = 1
        for a in _axes_tuple(axes):
            n *= self.shape[a]
        return n

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def _axes_tuple(axes: Optional[Axes]) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


class Mesh(AbstractMesh):
    """A live mesh over the initialised default process group (or over
    ``ranks``, a subset of it). ``device`` is where its tensors live: the
    rank's card, or the CPU."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 ranks: Optional[Sequence[int]] = None, device=None,
                 on_collective: Optional[Callable[[str, int, List[int]], None]] = None):
        super().__init__(shape, axes)
        self.on_collective = on_collective
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group "
                               "(launch.mesh.spawn_local, or init_process_group)")
        world = dist.get_world_size()
        self.ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if len(self.ranks) != self.size:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks, given "
                             f"{len(self.ranks)} of a world of {world}")
        self.backend = str(dist.get_backend())
        me = dist.get_rank()
        self.member = me in self.ranks
        self.rank = self.ranks.index(me) if self.member else -1
        self.coords = (tuple(int(c) for c in np.unravel_index(self.rank, self.devices.shape))
                       if self.member else ())
        self.device = torch.device(device if device is not None else "cpu")
        self._groups: Dict[Tuple[str, ...], object] = {}
        grid = np.arange(self.size).reshape(self.devices.shape)
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for sub in itertools.combinations(range(n), k):
                others = [i for i in range(n) if i not in sub]
                moved = np.transpose(grid, others + list(sub)).reshape(-1, self.axis_size(
                    tuple(self.axis_names[i] for i in sub)))
                key = tuple(self.axis_names[i] for i in sub)
                for line in moved:
                    members = [self.ranks[i] for i in line]
                    g = dist.new_group(members)
                    if self.member and self.ranks[self.rank] in members:
                        self._groups[key] = (g, members)

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        names = _axes_tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes: Axes):
        """(process group, its global ranks in group order) of the line
        through this rank along ``axes``."""
        return self._groups[self._key(axes)]

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[self.axis_names.index(a)]
        return idx


# ---------------------------------------------------------------------------
# Raw collectives (no autograd), staged through the host under gloo
# ---------------------------------------------------------------------------


_FP8 = tuple(getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2") if hasattr(torch, n))


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    """fp8 moves as bytes (the backends reduce no fp8, and move it only so)."""
    return x.view(torch.uint8) if x.dtype in _FP8 else x


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type != "cpu"


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(mesh: Mesh, kind: str, x: torch.Tensor, staged: bool, members: List[int],
           back: Optional[int] = None) -> None:
    """One call of ``kind`` on operand ``x`` over the group ``members``;
    staged, the operand goes to the host and ``back`` bytes (default: as
    many) come back to the card."""
    c = COUNTERS[kind]
    nbytes = _nbytes(x)
    c["calls"] += 1
    c["bytes"] += nbytes
    if staged:
        c["staged_bytes"] += nbytes + (nbytes if back is None else back)
    if mesh.on_collective is not None:
        mesh.on_collective(kind, nbytes, members)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes, op, kind: str) -> torch.Tensor:
    g, members = mesh.group(axes)
    staged = _staged(mesh, x)
    _count(mesh, kind, x, staged, members)
    buf = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
    dist.all_reduce(buf, op=op, group=g)
    return buf.to(x.device) if staged else buf


def _all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    g, members = mesh.group(axes)
    staged = _staged(mesh, x)
    _count(mesh, "all_gather", x, staged, members, back=len(members) * _nbytes(x))
    src = _bytes_view((x.detach().to("cpu") if staged else x.detach()).contiguous())
    parts = [torch.empty_like(src) for _ in members]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts, dim=dim).view(x.dtype)
    return out.to(x.device) if staged else out


def _all_to_all(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    g, members = mesh.group(axes)
    if x.shape[0] % len(members):
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not split "
                         f"{len(members)} ways")
    staged = _staged(mesh, x)
    _count(mesh, "all_to_all", x, staged, members)
    src = _bytes_view((x.detach().to("cpu") if staged else x.detach()).contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    out = out.view(x.dtype)
    return out.to(x.device) if staged else out


_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """Sum over the group; each rank keeps its block of ``dim`` (axis-index
    order, as ``_all_gather`` concatenates)."""
    g, members = mesh.group(axes)
    n = len(members)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} ({x.shape[dim]}) does not split {n} ways")
    staged = _staged(mesh, x)
    _count(mesh, "reduce_scatter", x, staged, members, back=_nbytes(x) // n)
    src = x.detach().movedim(dim, 0)
    src = (src.to("cpu") if staged else src).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _REDUCE_SCATTER(out, src, group=g)
    out = out.movedim(0, dim).contiguous()
    return out.to(x.device) if staged else out


def _ppermute(x: torch.Tensor, mesh: Mesh, axes: Axes,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send x from axis index src to dst for each (src, dst) of ``perm``;
    a rank that receives nothing gets zeros."""
    _, members = mesh.group(axes)
    me = mesh.axis_index(axes)
    staged = _staged(mesh, x)
    _count(mesh, "ppermute", x, staged, members)
    src = _bytes_view((x.detach().to("cpu") if staged else x.detach()).contiguous())
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, src, members[d]))
        if d == me and s != me:
            ops.append(dist.P2POp(dist.irecv, out, members[s]))
        if s == me and d == me:
            out.copy_(src)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = out.view(x.dtype)
    return out.to(x.device) if staged else out


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM, "psum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM, "psum"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        ctx.n = x.shape[dim]
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "scatter":
            g = _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        else:
            i = ctx.mesh.axis_index(ctx.axes)
            g = g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous()
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None, None, None


def _block(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"scatter: dim {dim} ({x.shape[dim]}) does not split {n} ways")
    b = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * b, b)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_to_all(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axes), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.mesh, ctx.axes, ctx.perm = mesh, axes, perm
        return _ppermute(x, mesh, axes, perm)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.mesh, ctx.axes, back), None, None, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Sum over the group; the backward passes each rank's cotangent through."""
    if _needs_grad(x):
        return _Psum.apply(x, mesh, axes)
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM, "psum")


def pmean(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh.axis_size(axes)


def pmax(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Elementwise maximum over the group (no gradient)."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX, "pmax")


def fan_out(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Identity; the backward sums the cotangents over the group. A no-op
    (and no collective) where no gradient flows."""
    if _needs_grad(x):
        return _FanOut.apply(x, mesh, axes)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0, *,
               grad: str = "scatter") -> torch.Tensor:
    """Concatenate the group's shards along ``dim`` in axis-index order.
    ``grad`` picks the backward: "scatter" (reduce-scatter) or "slice"."""
    if grad not in ("scatter", "slice"):
        raise ValueError(f"all_gather grad={grad!r}: 'scatter' or 'slice'")
    dim = dim % x.dim()
    if _needs_grad(x):
        return _AllGather.apply(x, mesh, axes, dim, grad)
    return _all_gather(x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """Sum over the group; each rank keeps its block of ``dim`` (axis-index
    order). The backward all-gathers the blocks' cotangents."""
    dim = dim % x.dim()
    if _needs_grad(x):
        return _ReduceScatter.apply(x, mesh, axes, dim)
    return _reduce_scatter(x, mesh, axes, dim)


def scatter(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``dim`` of a value replicated over the group (no
    communication). The backward all-gathers the blocks' cotangents, so the
    replicated value gets its whole cotangent on every rank."""
    dim = dim % x.dim()
    if _needs_grad(x):
        return _Scatter.apply(x, mesh, axes, dim)
    return _block(x, mesh, axes, dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """Tiled all-to-all: dim 0 splits into the group's size in chunks, chunk
    j goes to index j, and the received chunks concatenate on dim 0 in
    source order."""
    if _needs_grad(x):
        return _AllToAll.apply(x, mesh, axes)
    return _all_to_all(x, mesh, axes)


def ppermute(x: torch.Tensor, mesh: Mesh, axes: Axes,
             perm: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """Collective permute by axis index pairs (src, dst); ranks that receive
    nothing get zeros. The backward is the reverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if _needs_grad(x):
        return _Ppermute.apply(x, mesh, axes, perm)
    return _ppermute(x, mesh, axes, perm)


def axis_index(mesh: Mesh, axes: Axes) -> int:
    return mesh.axis_index(axes)


def axis_size(mesh: AbstractMesh, axes: Axes) -> int:
    return mesh.axis_size(axes)


def mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


__all__: List[str] = ["AbstractMesh", "COUNTERS", "Mesh", "P", "all_gather",
                      "all_to_all", "axis_index", "axis_size", "fan_out", "mesh_shape", "pmax",
                      "pmean", "ppermute", "psum", "reduce_scatter", "reset_counters", "scatter"]
