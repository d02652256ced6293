"""Elastic scaling: re-shard live state onto a different mesh (the port of
``repro.distributed.elastic``).

When nodes join or leave, training resumes on a new mesh: parameters and
optimizer state are re-laid-out with ``reshard_tree`` (each leaf gathered
whole on its old layout, then the new mesh's slice taken), the data
pipeline re-partitions by the new DP size (``rebatch_for_mesh``), and the
APC plan cache re-partitions by consistent hashing
(``core/distributed_cache.py``: only ~K/N keys move).

The new mesh may be a subset of the old world (a node lost): every rank of
the old mesh takes part in the gather; a rank outside the new mesh gets
``None`` back.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.configs.base import ShardingProfile
from repro_torch.distributed import sharding as shd


def reshard_tree(tree: Any, new_mesh, profile: ShardingProfile, *, old_mesh=None,
                 old_specs: Any = None) -> Optional[Any]:
    """Re-layout a parameter / optimizer tree for ``new_mesh`` under
    ``profile``. With ``old_mesh``, ``tree`` is this rank's shard of it cut
    by ``old_specs`` (``param_pspecs`` of the whole tree on the old mesh,
    e.g. ``ParallelCtx.param_specs(cfg)``; local shapes alone do not say
    which dims were split); without, ``tree`` is the whole tree."""
    whole = tree
    if old_mesh is not None:
        if old_specs is None:
            raise ValueError("reshard_tree from an old mesh needs the specs its shards "
                             "were cut by (old_specs)")
        whole = shd.unshard_tree(tree, old_specs, old_mesh)
    if not getattr(new_mesh, "member", True):
        return None
    return shd.shard_tree(whole, shd.param_pspecs(whole, profile, new_mesh), new_mesh)


def rescale_training_state(params: Any, opt_state: Any, new_mesh, profile: ShardingProfile,
                           *, old_mesh=None, old_specs: Any = None) -> Tuple[Any, Any]:
    """Parameters and AdamW state (``m``, ``v``, ``step``) onto ``new_mesh``
    (the state laid out as the parameters are)."""
    kw = {"old_mesh": old_mesh, "old_specs": old_specs}
    params = reshard_tree(params, new_mesh, profile, **kw)
    new_m = reshard_tree(opt_state["m"], new_mesh, profile, **kw)
    new_v = reshard_tree(opt_state["v"], new_mesh, profile, **kw)
    return params, {"m": new_m, "v": new_v, "step": opt_state["step"]}


def rebatch_for_mesh(global_batch: int, mesh) -> int:
    """Largest per-step batch divisible by the new DP extent."""
    dp = 1
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    for ax in ("pod", "data"):
        dp *= shape.get(ax, 1)
    return (global_batch // dp) * dp
