"""Rank bodies for the multi-rank tests of the KV prefix path under a mesh,
sequence parallelism and remat "dots" (``test_torch_mesh_prefix.py``,
``test_torch_seqpar.py``): each runs on every rank that
``repro_torch.launch.mesh.spawn_local`` starts (gloo on the CPU) and returns
plain numpy data. Imports torch and ``repro_torch`` only."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import CachePoint, KVPrefixCache, pool_for_config
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import (loss_fn, make_train_step, reduce_grads,
                                             value_and_grad)

torch.set_num_threads(1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _rows(x, mesh, axes, dim: int = 0):
    n = mesh.axis_size(axes)
    b = x.shape[dim] // n
    if isinstance(x, np.ndarray):
        return np.take(x, range(mesh.axis_index(axes) * b, (mesh.axis_index(axes) + 1) * b),
                       axis=dim)
    return x.narrow(dim, mesh.axis_index(axes) * b, b)


def smoke(arch: str, ep: bool = True, **kw):
    """The smoke config in fp32; a moe arch in mode "ep" at capacity factor
    8 (nothing drops, so the reference's dropless path is the oracle), or
    with ``ep=False`` in its own mode."""
    cfg = dataclasses.replace(registry.get_smoke(arch), dtype="float32",
                              param_dtype="float32", **kw)
    if cfg.moe is not None and ep:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, mode="ep",
                                                               capacity_factor=8.0))
    return cfg


# ---------------------------------------------------------------------------
# The KV prefix path under a mesh
# ---------------------------------------------------------------------------


def _pool_state(kv: KVPrefixCache) -> dict:
    return {"keys": kv.keys(), "free": kv.pool.free_pages,
            "refcount": kv.pool.refcount.tolist(), "pages_hit": kv.pages_hit,
            "pages_built": kv.pages_built, "evictions": kv.prefix_evictions,
            "lengths": {k: kv.length_of(k) for k in kv.keys()}}


def prefix_cases(rank: int, world: int, data: dict) -> dict:
    out: dict = {}
    mesh = lmesh.make_mesh(data["shape"], ("data", "model"))
    for arch, case in data["archs"].items():
        cfg = smoke(arch)
        prof = registry.get_sharding(arch)
        kv = KVPrefixCache(pool_for_config(cfg, num_pages=data["pages"],
                                           page_size=data["page_size"], device="cpu",
                                           mesh=mesh, profile=prof))
        eng = Engine(cfg, lm.params_from_jax(cfg, case["params"]), mesh=mesh, profile=prof,
                     device="cpu", max_len=data["max_len"], kv_prefix=kv)
        dp = eng.ctx.dp
        toks, Sp, forced = case["toks"], case["Sp"], case["forced"]
        rows, frows = _rows(toks, mesh, dp), _rows(forced, mesh, dp)
        rec: dict = {"nbytes": kv.pool.nbytes, "layout": kv.pool.page_layout}
        assert eng.prefill_with_prefix("tpl", rows[:, Sp:]) is None  # cold
        full, cache = eng.prefill(rows)
        rec["full"] = _np(mc.all_gather(full, mesh, dp, dim=0))
        assert eng.register_prefix("tpl", cache, Sp)
        reused0 = eng.stats.prefix_tokens_reused
        logits, pcache = eng.prefill_with_prefix("tpl", rows[:, Sp:])
        rec["reused"] = eng.stats.prefix_tokens_reused - reused0
        rec["cache_len"] = int(pcache["length"])
        steps = [logits]
        for i in range(forced.shape[1] - 1):
            logits, pcache = eng.decode(pcache, frows[:, i:i + 1])
            steps.append(logits)
        rec["prefix"] = np.stack([_np(mc.all_gather(t, mesh, dp, dim=0)) for t in steps])
        cp = CachePoint("gen", Sp)
        rec["gen_miss"] = eng.generate(toks, data["new"], cache_point=cp)
        rec["gen_hit"] = eng.generate(toks, data["new"], cache_point=cp)
        # a stale registration (another length) is refused, its lease given back
        assert eng.register_prefix("stale", cache, Sp - 4)
        rec["stale_refused"] = eng.prefill_with_prefix(
            "stale", rows[:, Sp:], expected_len=Sp) is None
        rec["pool"] = _pool_state(kv)
        out[arch] = rec
    # lockstep pool decisions: a stream that fills the pool, pins a prefix
    # with a lease and evicts by LRU (olmo, the first arch)
    arch = next(iter(data["archs"]))
    cfg, prof = smoke(arch), registry.get_sharding(arch)
    kv = KVPrefixCache(pool_for_config(cfg, num_pages=6, page_size=8, device="cpu", mesh=mesh,
                                       profile=prof))
    eng = Engine(cfg, lm.params_from_jax(cfg, data["archs"][arch]["params"]), mesh=mesh,
                 profile=prof, device="cpu", max_len=data["max_len"], kv_prefix=kv)
    rows = _rows(data["archs"][arch]["toks"], mesh, eng.ctx.dp)
    _, cache = eng.prefill(rows)
    stream = []
    for tid in ("a", "b", "c"):
        stream.append(("put", tid, eng.register_prefix(tid, cache, 16), _pool_state(kv)))
    lease = kv.acquire("a")
    stream.append(("put", "d", eng.register_prefix("d", cache, 16), _pool_state(kv)))
    stream.append(("put", "e", eng.register_prefix("e", cache, 16), _pool_state(kv)))
    kv.release_lease(lease)
    stream.append(("release", "a", kv.release("a"), _pool_state(kv)))
    out["stream"] = stream
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism and remat "dots"
# ---------------------------------------------------------------------------


class _OpCount(TorchDispatchMode):
    """Counts aten ops run under it: matrix products and the rest."""

    DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    def __init__(self):
        super().__init__()
        self.mm = 0
        self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.DOTS:
            self.mm += 1
        elif not getattr(func, "is_view", False):
            self.other += 1
        return func(*args, **(kwargs or {}))


def _counts():
    return {k: v["calls"] for k, v in mc.COUNTERS.items() if v["calls"]}


def seqpar_cases(rank: int, world: int, data: dict) -> dict:
    out: dict = {}
    mesh = lmesh.make_mesh((2, 2), ("data", "model"))
    # prefill under seq_parallel, every family but audio
    for arch, case in data["prefill"].items():
        cfg = smoke(arch)
        params = lm.params_from_jax(cfg, case["params"])
        for sp in (False, True):
            prof = dataclasses.replace(registry.get_sharding(arch), seq_parallel=sp)
            ctx = lm.ParallelCtx.from_profile(mesh, prof)
            local = shd.shard_tree(params, shd.param_pspecs(params, prof, mesh), mesh)
            for S, toks in case["tokens"].items():
                mc.reset_counters()
                logits, c = lm.prefill(cfg, local, _rows(torch.from_numpy(toks), mesh, ctx.dp),
                                       cache_len=S + 1, ctx=ctx)
                key = f"{arch}/{S}/{'sp' if sp else 'tp'}"
                out[key] = {"logits": _np(mc.all_gather(logits, mesh, ctx.dp, dim=0)),
                            "counts": _counts()}
                if sp:  # decode continues from the sequence-parallel prefill's cache
                    nxt = _rows(torch.from_numpy(case["next"]), mesh, ctx.dp)
                    dec, _ = lm.decode_step(cfg, local, c, nxt, ctx=ctx)
                    out[key]["decode"] = _np(mc.all_gather(dec, mesh, ctx.dp, dim=0))
    # gradients of the families' loss under tensor and sequence parallelism
    for arch, case in data["grads"].items():
        cfg = smoke(arch, ep=False)
        params = lm.params_from_jax(cfg, case["params"])
        seq = torch.from_numpy(case["seq"])
        for sp in (False, True):
            prof = dataclasses.replace(registry.get_sharding(arch), seq_parallel=sp)
            ctx = lm.ParallelCtx.from_profile(mesh, prof)
            specs = shd.param_pspecs(params, prof, mesh)
            local = shd.shard_tree(params, specs, mesh)
            lb = {"tokens": _rows(seq[:, :-1], mesh, ctx.dp),
                  "labels": _rows(seq[:, 1:], mesh, ctx.dp)}
            loss, _, g = value_and_grad(cfg, local, lb, ctx)
            g, _ = reduce_grads(ctx, specs, g)
            out[f"grads/{arch}/{'sp' if sp else 'tp'}"] = {
                "loss": float(loss),
                "grads": [_np(t) for t in tree_leaves(shd.unshard_tree(g, specs, mesh))]}
    # one AdamW step of olmo under seq_parallel, and under remat "dots"
    cfg = smoke("olmo-1b")
    params = lm.params_from_jax(cfg, data["olmo_params"])
    opt_cfg = AdamWConfig(lr=1e-3)
    base = registry.get_sharding("olmo-1b")
    for name, prof in (("sp", dataclasses.replace(base, seq_parallel=True)),
                       ("dots", dataclasses.replace(base, remat="dots"))):
        ctx = lm.ParallelCtx.from_profile(mesh, prof)
        specs = shd.param_pspecs(params, prof, mesh)
        local = shd.shard_tree(params, specs, mesh)
        for S, seq in data["train"].items():
            b = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
            lb = {k: _rows(v, mesh, ctx.dp) for k, v in b.items()}
            new, _, m = make_train_step(cfg, opt_cfg, ctx)(local, adamw_init(local, opt_cfg), lb)
            out[f"train/{name}/{S}"] = {
                "loss": float(m["loss"]),
                "params": [_np(t) for t in tree_leaves(shd.unshard_tree(new, specs, mesh))]}
    # remat "none" / "dots" / "full" on the serving profile: gradients, and
    # the ops the backward runs (products kept vs recomputed)
    seq = data["train"][max(data["train"])]
    b = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
    for remat in ("none", "dots", "full"):
        prof = dataclasses.replace(base, remat=remat)
        ctx = lm.ParallelCtx.from_profile(mesh, prof)
        specs = shd.param_pspecs(params, prof, mesh)
        local = shd.shard_tree(params, specs, mesh)
        lb = {k: _rows(v, mesh, ctx.dp) for k, v in b.items()}
        live = tree_map(lambda p: p.detach().requires_grad_(True), local)
        with torch.enable_grad():
            fwd = _OpCount()
            with fwd:
                loss, _ = loss_fn(cfg, live, lb, ctx)
            mc.reset_counters()
            bwd = _OpCount()
            with bwd:
                grads = torch.autograd.grad(loss, tree_leaves(live))
        out[f"remat/{remat}"] = {
            "loss": float(loss), "fwd": (fwd.mm, fwd.other), "bwd": (bwd.mm, bwd.other),
            "bwd_psum": mc.COUNTERS["psum"]["calls"],
            "grads": [_np(g) for g in grads]}
    return out
