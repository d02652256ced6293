"""Rank bodies for the multi-rank tests (``test_torch_parallel*.py``): each
runs on every rank that ``repro_torch.launch.mesh.spawn_local`` starts
(gloo on the CPU) and returns plain numpy data. Imports torch and
``repro_torch`` only, so the ranks start without jax."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import mesh_compat as mc
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import (rebatch_for_mesh, rescale_training_state,
                                             reshard_tree)
from repro_torch.distributed.mesh_compat import Mesh
from repro_torch.distributed.pipeline import pipeline_apply, sequential_reference
from repro_torch.launch import mesh as lmesh
from repro_torch.models import lm, moe
from repro_torch.models.common import tree_leaves
from repro_torch.serving.engine import Engine
from repro_torch.training.grad_compress import compressed_allreduce, ef_state_init
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step

torch.set_num_threads(1)

# tests/test_distributed.py's expert-parallel config
EP_CFG = ModelConfig(name="t", family="moe", num_layers=1, d_model=64, num_heads=4,
                     num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
                     moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32,
                                   capacity_factor=8.0, mode="ep"),
                     param_dtype="float32", dtype="float32")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


def _rows(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    n = mesh.axis_size(axes)
    b = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axes) * b, b)


def _smoke(arch: str, **kw):
    return dataclasses.replace(registry.get_smoke(arch), dtype="float32",
                               param_dtype="float32", **kw)


# ---------------------------------------------------------------------------
# The training-side cases: one world of 8 ranks
# ---------------------------------------------------------------------------


def train_cases(rank: int, world: int, data: dict) -> dict:
    out: dict = {}
    mesh = lmesh.make_mesh((2, 4), ("data", "model"))

    # sharded train step, olmo smoke fp32, (2, 4): the serving profile (TP
    # over model, dp over data) and the train profile (FSDP over both),
    # both with remat "full"; then the serving profile without remat
    cfg = _smoke("olmo-1b")
    params = lm.params_from_jax(cfg, data["olmo_params"])
    batch = {k: torch.from_numpy(v) for k, v in data["olmo_batch"].items()}
    opt_cfg = AdamWConfig(lr=1e-3)
    mesh4 = Mesh((1, 4), ("data", "model"), ranks=[0, 1, 2, 3])
    for kind in ("", "train", "noremat"):
        profile = registry.get_sharding("olmo-1b", "" if kind == "noremat" else kind)
        if kind == "noremat":
            profile = dataclasses.replace(profile, remat="none")
        ctx = lm.ParallelCtx.from_profile(mesh, profile)
        specs = shd.param_pspecs(params, profile, mesh)
        local = shd.shard_tree(params, specs, mesh)
        opt = adamw_init(local, opt_cfg)
        lb = {k: _rows(v, mesh, ctx.dp) for k, v in batch.items()}
        calls = mc.COUNTERS["psum"]["calls"]
        new_p, new_opt, m = make_train_step(cfg, opt_cfg, ctx)(local, opt, lb)
        out[f"train{kind}/psum_calls"] = mc.COUNTERS["psum"]["calls"] - calls
        whole = shd.unshard_tree(new_p, specs, mesh)
        out[f"train{kind}/loss"] = float(m["loss"])
        out[f"train{kind}/params"] = [_np(t) for t in tree_leaves(whole)]
        if kind == "train":
            # elastic: the stepped FSDP state onto (1, 4) over the first
            # four ranks, gathered back against the state gathered on (2, 4)
            state = {"p": whole, "m": shd.unshard_tree(new_opt["m"], specs, mesh),
                     "v": shd.unshard_tree(new_opt["v"], specs, mesh)}
            p4, opt4 = rescale_training_state(new_p, new_opt, mesh4, profile, old_mesh=mesh,
                                              old_specs=specs)
            if mesh4.member:
                specs4 = shd.param_pspecs(params, profile, mesh4)
                back = {"p": p4, "m": opt4["m"], "v": opt4["v"]}
                out["rescale/maxdiff"] = {
                    k: max(float((a - b).abs().max()) for a, b in zip(
                        tree_leaves(state[k]), tree_leaves(shd.unshard_tree(back[k], specs4,
                                                                            mesh4))))
                    for k in state}
                out["rescale/step"] = (int(opt4["step"]), int(new_opt["step"]))
                out["rescale/local_numel"] = sum(t.numel() for t in tree_leaves(p4))
            else:
                out["rescale/none"] = p4 is None and opt4["m"] is None

    # expert parallelism on (2, 4): cf 8 (no drops), cf 1.25, fp8 wire
    p_ep = {k: torch.from_numpy(v) for k, v in data["ep_params"].items()}
    x = torch.from_numpy(data["ep_x"])
    local_p = dict(p_ep)
    for k in ("w_gate", "w_up", "w_down"):
        local_p[k] = _rows(p_ep[k], mesh, "model").clone()
    xl = _rows(x, mesh, "data")
    for name, cfg_ep in (("ep8", EP_CFG),
                         ("ep125", _ep(capacity_factor=1.25)),
                         ("epfp8", _ep(capacity_factor=1.25, a2a_dtype="float8_e4m3fn")),
                         ("epch2", _ep(capacity_factor=1.25, dispatch_chunks=2))):
        moe.moe_forward_ep.dropped = 0
        y, aux = moe.moe_forward_ep(cfg_ep, local_p, xl, mesh=mesh, ep_axis="model",
                                    dp_axes=("data",))
        out[f"{name}/y"] = _np(mc.all_gather(y, mesh, "data", dim=0))
        out[f"{name}/aux"] = float(aux)
        dropped = torch.as_tensor(moe.moe_forward_ep.dropped).reshape(1)
        out[f"{name}/dropped"] = int(mc.psum(dropped, mesh, "data"))

    # compressed_allreduce over 8 ranks of one axis: the host mesh
    flat = lmesh.make_host_mesh()
    out["host_mesh"] = (flat.axis_names, flat.devices.shape, flat.axis_index("data"))
    g = torch.from_numpy(data["ar_grads"][rank:rank + 1])
    ef = ef_state_init({"w": torch.zeros(data["ar_grads"].shape[1])})
    red, new_ef = compressed_allreduce({"w": g}, ef, flat, "data")
    out["ar/out"] = _np(red["w"])
    out["ar/ef"] = _np(new_ef["w"])

    # pipeline over the first 4 ranks
    pipe = Mesh((4,), ("pipe",), ranks=[0, 1, 2, 3])
    if pipe.member:
        ws = torch.from_numpy(data["pipe_ws"])
        xp = torch.from_numpy(data["pipe_x"])

        def layer_fn(w, h):
            return torch.tanh(h @ w) + h

        y = pipeline_apply(layer_fn, ws, xp, mesh=pipe, axis="pipe", n_microbatches=4)
        wl = ws.clone().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.sum(pipeline_apply(layer_fn, wl, xp, mesh=pipe, axis="pipe",
                                            n_microbatches=4) ** 2)
            (gw,) = torch.autograd.grad(loss, [wl])
        gw = mc.psum(gw, pipe, "pipe")  # each stage holds its layers' gradient
        out["pipe/y"] = _np(y)
        out["pipe/g"] = _np(gw)
        out["pipe/seq"] = _np(sequential_reference(layer_fn, ws, xp))

    # elastic: (2, 4) -> (1, 4) over the first 4 ranks (a node lost)
    qcfg = _smoke("qwen2.5-3b")
    qparams = lm.params_from_jax(qcfg, data["qwen_params"])
    prof = registry.get_sharding("qwen2.5-3b")
    specs8 = shd.param_pspecs(qparams, prof, mesh)
    p8 = shd.shard_tree(qparams, specs8, mesh)
    p4 = reshard_tree(p8, mesh4, prof, old_mesh=mesh, old_specs=specs8)
    if mesh4.member:
        back = shd.unshard_tree(p4, shd.param_pspecs(qparams, prof, mesh4), mesh4)
        out["reshard/maxdiff"] = max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(tree_leaves(qparams), tree_leaves(back)))
        out["reshard/local_numel"] = sum(t.numel() for t in tree_leaves(p4))
    out["rebatch"] = (rebatch_for_mesh(30, mesh), rebatch_for_mesh(30, mesh4))
    out["counters"] = {k: dict(v) for k, v in mc.COUNTERS.items()}
    return out


def _ep(**kw):
    return dataclasses.replace(EP_CFG, moe=dataclasses.replace(EP_CFG.moe, **kw))


# ---------------------------------------------------------------------------
# The model cases: every family's sharded prefill and decode, the engine
# ---------------------------------------------------------------------------


def _count_attention_calls():
    """Wrap the attention ops to count calls by (q heads, kv heads); returns
    the counts and an undo."""
    from repro_torch.kernels import ops

    seen = {"flash": {}, "decode": {}}
    orig = {"flash": ops.flash_attention_op, "decode": ops.decode_attention_op}

    def wrap(name):
        def call(q, k, *a, **kw):
            key = f"{q.shape[2]}/{k.shape[2]}"
            seen[name][key] = seen[name].get(key, 0) + 1
            return orig[name](q, k, *a, **kw)
        return call

    ops.flash_attention_op, ops.decode_attention_op = wrap("flash"), wrap("decode")

    def undo():
        ops.flash_attention_op, ops.decode_attention_op = orig["flash"], orig["decode"]

    return seen, undo


def model_cases(rank: int, world: int, data: dict) -> dict:
    out: dict = {}
    mesh = lmesh.make_mesh((2, 4), ("data", "model"))
    for arch, case in data["families"].items():
        cfg = _smoke(arch, **case.get("cfg", {}))
        params = lm.params_from_jax(cfg, case["params"])
        profile = registry.get_sharding(arch)
        ctx = lm.ParallelCtx.from_profile(mesh, profile)
        local = shd.shard_tree(params, shd.param_pspecs(params, profile, mesh), mesh)
        inputs = {}
        for k, v in case["inputs"].items():
            t = torch.from_numpy(v)
            inputs[k] = _rows(t, mesh, ctx.dp, dim=1 if k == "positions" else 0)
        tokens = inputs.pop("tokens", None)
        seen, undo = _count_attention_calls()
        try:
            logits, cache = lm.prefill(cfg, local, tokens, cache_len=case["cache_len"],
                                       ctx=ctx, **inputs)
            step = _rows(torch.from_numpy(case["next"]), mesh, ctx.dp)
            dec, cache = lm.decode_step(cfg, local, cache, step, ctx=ctx)
            dec2, _ = lm.decode_step(cfg, local, cache, step, ctx=ctx)
        finally:
            undo()
        out[arch] = {n: _np(mc.all_gather(t, mesh, ctx.dp, dim=0))
                     for n, t in (("prefill", logits), ("decode", dec), ("decode2", dec2))}
        out[arch]["calls"] = seen
    # Engine(mesh=): greedy tokens on smoke olmo
    cfg = _smoke("olmo-1b")
    eng = Engine(cfg, lm.params_from_jax(cfg, data["engine"]["params"]), mesh=mesh,
                 profile=registry.get_sharding("olmo-1b"), device="cpu", max_len=64)
    out["engine"] = eng.generate(data["engine"]["prompts"], data["engine"]["max_new"])
    out["counters"] = {k: dict(v) for k, v in mc.COUNTERS.items()}
    return out
