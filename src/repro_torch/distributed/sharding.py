"""Parameter / activation sharding rules (the port of
``repro.distributed.sharding``), and the trees of this rank's shards.

``param_pspecs(params, profile, mesh)`` walks the parameter tree (by path)
and gives each leaf a ``P`` (``distributed/mesh_compat.py``):

  * Megatron TP over ``profile.tp_axis``: column-shard up-projections
    (wq/wk/wv/w_gate/w_up), row-shard down-projections (wo/w_down).
  * FSDP (ZeRO-3) over ``profile.fsdp_axes``: shard the *other* matrix dim.
  * EP over ``profile.ep_axis`` for MoE expert stacks.
  * Vocab sharding for embed/head.

Every axis assignment is divisibility-guarded: if a dim doesn't divide by
the mesh extent it falls back to replication on that dim (e.g. GQA
kv-heads < TP size). The tables and the guard are the reference's, so the
specs equal its ``PartitionSpec``s entry for entry. A path is the tuple of
dict keys and list indices down to the leaf; the port's layer lists hold
no stacked leading axis, so its layer leaves have no leading ``None``.

``shard_tree(tree, specs, mesh)`` gives this rank's slice of every leaf
(a leaf replicated on a dim keeps the whole dim); ``unshard_tree`` gathers
the slices back. The reference's ``to_shardings`` / ``param_shardings``
turn specs into ``NamedSharding``s for XLA; a torch tensor carries no
sharding, so they have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShardingProfile
from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed.mesh_compat import P


def _axes_size(mesh_shape: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_shape.get(axes, 1)
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def _guard(spec_entry, dim: int, mesh_shape: Dict[str, int]):
    """Drop a sharding assignment whose extent doesn't divide the dim."""
    if spec_entry is None:
        return None
    if dim % _axes_size(mesh_shape, spec_entry) == 0:
        return spec_entry
    return None


def _present_axes(axes: Tuple[str, ...], mesh_shape: Dict[str, int]):
    out = tuple(a for a in axes if a in mesh_shape)
    if not out:
        return None
    return out if len(out) > 1 else out[0]


# trailing-dims role table; leading dims (layer stacks) padded with None.
# roles: 'fsdp' | 'tp' | 'ep' | 'vocab' | None
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
    "dec_pos": (None, "fsdp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # dense mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (rank includes expert dim) — see override below
    "router": ("fsdp", None),
    # rwkv
    "wr": ("fsdp", "tp"),
    "wg": ("fsdp", "tp"),
    "ck": ("fsdp", "tp"),
    "cv": ("tp", "fsdp"),
    "cr": ("fsdp", "tp"),
    "w_lora_a": (None, None),
    "w_lora_b": (None, None),
    # mamba
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "norm_scale": ("tp",),
}

_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("ep", "fsdp", None),
    "w_up": ("ep", "fsdp", None),
    "w_down": ("ep", None, "fsdp"),
    "router": ("fsdp", None),
}


def _role_to_axes(role: Optional[str], profile: ShardingProfile, mesh_shape):
    if role is None:
        return None
    if role == "fsdp":
        return _present_axes(profile.fsdp_axes, mesh_shape)
    if role == "tp" or role == "vocab":
        if not profile.tp_axis:  # TP disabled (model axis used as DP)
            return None
        return profile.tp_axis if profile.tp_axis in mesh_shape else None
    if role == "ep":
        return profile.ep_axis if profile.ep_axis in mesh_shape else None
    raise ValueError(role)


def spec_for_param(path: Tuple[str, ...], shape: Tuple[int, ...],
                   profile: ShardingProfile, mesh_shape: Dict[str, int]) -> P:
    leaf = path[-1]
    in_moe = "moe" in path
    rules = _MOE_RULES if in_moe and leaf in _MOE_RULES else _RULES
    roles = rules.get(leaf)
    if not profile.shard_kv_proj and leaf in ("wk", "wv", "bk", "bv") and not in_moe:
        roles = tuple("fsdp" if r == "fsdp" else None for r in (roles or ()))
    if roles is None:
        return P()  # replicate (norm scales, mixes, biases of recurrences...)
    ndim = len(shape)
    lead = ndim - len(roles)
    if lead < 0:  # scalar-ish param with a rule (shouldn't happen)
        return P()
    entries = [None] * lead
    for i, role in enumerate(roles):
        ax = _role_to_axes(role, profile, mesh_shape)
        entries.append(_guard(ax, shape[lead + i], mesh_shape))
    # avoid reusing a mesh axis twice in one spec (illegal)
    seen = set()
    clean = []
    for e in entries:
        names = (e,) if isinstance(e, str) else (e or ())
        if any(n in seen for n in names):
            clean.append(None)
            continue
        seen.update(names)
        clean.append(e)
    return P(*clean)


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree (a spec is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_specs(fn, v, specs[i]) for i, v in enumerate(tree)]
    return fn(tree, specs)


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a tuple,
    which the generic walk would descend into)."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def param_pspecs(params: Any, profile: ShardingProfile, mesh) -> Any:
    """``P`` tree matching ``params`` (tensors, meta tensors included)."""
    mesh_shape = mc.mesh_shape(mesh)
    return _map_with_path(
        lambda path, leaf: spec_for_param(path, tuple(leaf.shape), profile, mesh_shape),
        params)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def dp_axes_for_mesh(mesh, profile: Optional[ShardingProfile] = None) -> Tuple[str, ...]:
    """Batch axes: ('pod', 'data') when pod exists (+ profile extras)."""
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    if profile is not None:
        dp += tuple(a for a in profile.extra_dp_axes if a in names and a not in dp)
    return dp


def batch_entry(mesh, profile: Optional[ShardingProfile] = None):
    dp = dp_axes_for_mesh(mesh, profile)
    return dp if len(dp) > 1 else dp[0]


def batch_pspecs(batch: Any, mesh, profile: Optional[ShardingProfile] = None) -> Any:
    """Shard leading (batch) dim of every input over the DP axes; with
    ``profile.seq_parallel``, also shard the sequence dim over tp_axis.

    VLM positions have shape (3, B, S) — batch is dim 1 there; detected by
    rank-3 arrays under key 'positions'.
    """
    be = batch_entry(mesh, profile)
    mesh_shape = mc.mesh_shape(mesh)
    sp = None
    if profile is not None and profile.seq_parallel and profile.tp_axis:
        sp = profile.tp_axis if profile.tp_axis in mesh_shape else None

    def one(path, leaf):
        if path and path[-1] == "positions" and leaf.dim() == 3:
            return P(None, _guard(be, leaf.shape[1], mesh_shape),
                     _guard(sp, leaf.shape[2], mesh_shape))
        if leaf.dim() == 0:
            return P()
        entries = [_guard(be, leaf.shape[0], mesh_shape)]
        if leaf.dim() >= 2 and sp:
            entries.append(_guard(sp, leaf.shape[1], mesh_shape))
        entries += [None] * (leaf.dim() - len(entries))
        return P(*entries)

    return _map_with_path(one, batch)


def cache_pspecs(cache: Any, cfg: ModelConfig, profile: ShardingProfile, mesh) -> Any:
    """KV caches: batch over DP; head-or-headdim over TP (divisibility-
    guarded), or the sequence with ``shard_kv_seq``; SSM states: batch
    over DP, head dim over TP. A non-tensor leaf (the port's int
    ``length``) is replicated."""
    be = batch_entry(mesh, profile)
    mesh_shape = mc.mesh_shape(mesh)
    tp = profile.tp_axis if (profile.tp_axis and profile.tp_axis in mesh_shape) else None

    def one(path, leaf):
        nm = path[-1]
        if nm == "length" or not hasattr(leaf, "shape"):
            return P()
        if nm in ("kv_k", "kv_v", "cross_k", "cross_v"):
            # (L, B, M, H, hd) — prefer head sharding, else shard head_dim,
            # optionally shard sequence (shard_kv_seq) instead.
            L, B, M, H, hd = leaf.shape
            b = _guard(be, B, mesh_shape)
            if profile.shard_kv_seq and tp and M % mesh_shape[tp] == 0:
                return P(None, b, tp, None, None)
            if tp and H % mesh_shape[tp] == 0:
                return P(None, b, None, tp, None)
            if tp and hd % mesh_shape[tp] == 0:
                return P(None, b, None, None, tp)
            return P(None, b, None, None, None)
        if nm == "ssm_state":
            # (..., B, H, P, N) with leading layer dims
            lead = leaf.dim() - 4
            B, H, Pd, N = leaf.shape[lead:]
            b = _guard(be, B, mesh_shape)
            h = _guard(tp, H, mesh_shape)
            return P(*([None] * lead), b, h, None, None)
        if nm in ("shift_tm", "shift_cm"):
            L, B, D = leaf.shape
            return P(None, _guard(be, B, mesh_shape), _guard(tp, D, mesh_shape))
        if nm == "conv":
            lead = leaf.dim() - 3
            B, K, CH = leaf.shape[lead:]
            return P(*([None] * lead), _guard(be, B, mesh_shape), None,
                     _guard(tp, CH, mesh_shape))
        return P()

    return _map_with_path(one, cache)


# ---------------------------------------------------------------------------
# This rank's shards
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes a spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slice(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec``."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        size = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(axes) * size, size)
    return x


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's slice of every leaf (a contiguous copy; non-tensor leaves
    as they are)."""
    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return local_slice(x, spec, mesh).contiguous().clone()

    return map_with_specs(one, tree, specs)


def gather_leaf(x: torch.Tensor, spec: P, mesh, *, keep: Tuple[str, ...] = (),
                dp: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
    """All-gather every sharded dim of a leaf but those over an axis of
    ``keep`` (they stay this rank's). In a backward, a dim gathered over
    data-parallel axes (``dp``; every axis when None) reduce-scatters its
    gradient (each rank used the whole on its own data: FSDP), any other
    takes the rank's slice (the whole was used replicated)."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes or any(a in keep for a in axes):
            continue
        on_dp = [dp is None or a in dp for a in axes]
        if any(on_dp) and not all(on_dp):
            raise NotImplementedError(f"a dim sharded over data and other axes at once: {axes}")
        x = mc.all_gather(x, mesh, axes, dim=d, grad="scatter" if all(on_dp) else "slice")
    return x


def unshard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Gather the slices of ``shard_tree`` back into whole leaves."""
    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return gather_leaf(x, spec, mesh)

    return map_with_specs(one, tree, specs)
