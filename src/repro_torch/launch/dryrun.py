"""Multi-pod dry-run: every (arch x shape) cell on the production meshes, on
the meta device, with its FLOPs, bytes and collectives counted (the port of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell for 256 or 512 forced host
devices and parses the compiled program. Here one process plays rank 0 of
the production mesh: a fake process group (torch's test backend, which
completes every collective at once and moves no data) at world 256 or 512,
a live ``Mesh`` of ``launch.mesh.make_production_mesh``'s shape over it,
rank 0's shards of the abstract parameters (``param_pspecs``), of the
optimizer state and of the inputs (``launch.specs.input_specs``), all meta
tensors, and the cell's step run once on them (the train step with AdamW,
the prefill, or one ``decode_step``) under ``launch.roofline``'s counters:
FLOPs, the unfused byte upper bound, and every collective with its group.
Meta tensors compute nothing and take the kernels' plain versions
(``kernels/ops.py``), so the counts are those of the plain programs on
rank 0's shapes; no card is needed and none is touched.

Each record goes to ``results/dryrun/<arch>__<shape>__<mesh><tag>.json``
with the reference's keys. ``memory.argument_bytes`` is the exact bytes of
rank 0's shards; the temporaries cannot be measured on meta, so
``temp_bytes`` is null and ``temp_note`` says why. There is no compiled
program: ``hlo`` is null, ``lower_s`` is the time to build the shards and
``compile_s`` the time of the counted run. The process group lives only
inside ``run_cell``; nothing is initialised at import.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"
TEMP_NOTE = ("not measured: meta tensors hold no storage and the port compiles no "
             "program whose buffers could be counted")


# Named perf-iteration variants: each maps (cfg, profile) -> (cfg, profile)
# for a hypothesis under test (the reference's eight).
def _v_seq_parallel(cfg, profile):
    return cfg, dataclasses.replace(profile, seq_parallel=True)


def _v_model_as_dp(cfg, profile):
    return cfg, dataclasses.replace(
        profile, tp_axis="", extra_dp_axes=("model",),
        fsdp_axes=("data", "model"),
    )


def _v_fp8_dispatch(cfg, profile):
    assert cfg.moe is not None
    moe = dataclasses.replace(
        cfg.moe, a2a_dtype="float8_e4m3fn", capacity_factor=1.0,
        dispatch_chunks=4,
    )
    return dataclasses.replace(cfg, moe=moe), profile


def _v_fp8_dispatch_nochunk(cfg, profile):
    assert cfg.moe is not None
    moe = dataclasses.replace(cfg.moe, a2a_dtype="float8_e4m3fn",
                              capacity_factor=1.0)
    return dataclasses.replace(cfg, moe=moe), profile


def _v_granite_ep(cfg, profile):
    moe = dataclasses.replace(cfg.moe, mode="ep")
    return dataclasses.replace(cfg, moe=moe), profile


def _v_pad_heads(cfg, profile):
    # pad q heads to the next multiple of tp (28 -> 32) so head sharding is
    # clean, and replicate the (cheap) K/V projections instead of splitting
    # them within heads.
    return (
        dataclasses.replace(cfg, num_heads=32),
        dataclasses.replace(profile, shard_kv_proj=False),
    )


def _v_kimi_iter2(cfg, profile):
    cfg, profile = _v_fp8_dispatch(cfg, profile)
    return dataclasses.replace(cfg, attn_chunk=1024), profile


def _v_kv_seq(cfg, profile):
    return cfg, dataclasses.replace(profile, shard_kv_seq=True)


VARIANTS = {
    "seqpar": _v_seq_parallel,
    "padheads": _v_pad_heads,
    "kimi2": _v_kimi_iter2,
    "kvseq": _v_kv_seq,
    "modeldp": _v_model_as_dp,
    "fp8a2a": _v_fp8_dispatch,
    "fp8a2a_nochunk": _v_fp8_dispatch_nochunk,
    "graniteep": _v_granite_ep,
}


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in which this process is rank
    0, torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dry-run: a process group is already initialised")
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(arch: str, shape_name: str, mesh, *, remat_override=None,
               profile_override=None, variant: str = ""):
    """Returns (step, args): the cell's step as a function of rank 0's meta
    shards ``args`` on the live ``mesh``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    profile = profile_override or registry.get_sharding(arch, shape.kind)
    if remat_override is not None:
        profile = dataclasses.replace(profile, remat=remat_override)
    if variant:
        cfg, profile = VARIANTS[variant](cfg, profile)
    ctx = lm.ParallelCtx.from_profile(mesh, profile)

    params = lm.abstract_params(cfg)
    local = shd.shard_tree(params, shd.param_pspecs(params, profile, mesh), mesh)
    batch, cache = input_specs(cfg, shape)
    # the port's forwards take whole rows and shard the sequence themselves
    rows = dataclasses.replace(profile, seq_parallel=False)
    lbatch = shd.shard_tree(batch, shd.batch_pspecs(batch, mesh, rows), mesh)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=profile.optimizer_dtype)
        opt = adamw_init(local, opt_cfg)
        step = make_train_step(cfg, opt_cfg, ctx)
        return step, (local, opt, lbatch)

    inputs = {k: v for k, v in lbatch.items() if k != "tokens"}
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            logits, cache = lm.prefill(cfg, params, batch.get("tokens"), ctx=ctx, **inputs)
            return logits[:, -1], cache

        return prefill_fn, (local, lbatch)

    # decode
    lcache = shd.shard_tree(cache, shd.cache_pspecs(cache, cfg, profile, mesh), mesh)
    lcache["max_len"] = cache["kv_k"].shape[2] if "kv_k" in cache else 0

    def decode_fn(params, cache, batch):
        return lm.decode_step(cfg, params, cache, batch["tokens"], ctx=ctx)

    return decode_fn, (local, lcache, lbatch)


def measure(step, args, log):
    """Run ``step(*args)`` once under the counters: (outputs, record of the
    FLOPs, the byte upper bound, and the collectives ``log`` (a
    ``roofline.CollectiveLog``, the mesh's ``on_collective``) saw)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline

    with FlopCounterMode(display=False) as flops, roofline.byte_counter() as nbytes:
        out = step(*args)
    cost = {"flops": float(flops.get_total_flops()), "bytes_upper": float(nbytes.bytes),
            "ops": nbytes.ops,
            "coll_bytes": {k: float(v) for k, v in log.cost.coll_bytes.items()},
            "coll_count": dict(log.cost.coll_count),
            "coll_bytes_intra_node": log.intra_bytes, "coll_bytes_inter_node": log.inter_bytes,
            "coll_s": log.seconds}
    return out, cost


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, tag: str = "",
             remat_override=None, variant: str = "", results: Path = None) -> dict:
    from repro_torch.distributed.mesh_compat import Mesh
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_production_mesh

    results = Path(results) if results is not None else RESULTS
    t0 = time.time()
    shape = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(shape.axis_names, shape.devices.shape)),
        "tag": tag, "variant": variant, "ok": False, "rank": 0, "hlo": None,
    }
    try:
        with fake_world(shape.size):
            log = roofline.CollectiveLog()
            mesh = Mesh(shape.devices.shape, shape.axis_names, device="meta", on_collective=log)
            step, args = build_cell(arch, shape_name, mesh, remat_override=remat_override,
                                    variant=variant)
            t1 = time.time()
            out, cost = measure(step, args, log)
            t2 = time.time()
        rec["lower_s"] = round(t1 - t0, 2)
        rec["compile_s"] = round(t2 - t1, 2)
        rec["memory"] = {
            "argument_bytes": roofline.tree_bytes(args),
            "output_bytes": roofline.tree_bytes(out),
            "temp_bytes": None,
            "generated_code_bytes": None,
            "temp_note": TEMP_NOTE,
        }
        rec["cost_analysis"] = {"flops": cost["flops"], "bytes accessed": cost["bytes_upper"]}
        rec["cost"] = cost
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    results.mkdir(parents=True, exist_ok=True)
    path = results / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    path.write_text(json.dumps(rec, indent=2))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error')})"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}{tag}: {status} "
          f"in {rec['total_s']}s", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--variant", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--results", default=None, help="directory of the records "
                    "(default results/dryrun at the repo root)")
    args = ap.parse_args()
    results = Path(args.results) if args.results else RESULTS

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = registry.all_cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = 0
    for arch, shape in cells:
        for mk in meshes:
            if args.skip_existing:
                f = results / f"{arch}__{shape}__{mk}{args.tag}.json"
                if f.exists() and json.loads(f.read_text()).get("ok"):
                    print(f"[dryrun] skip existing {arch} x {shape} x {mk}")
                    n_ok += 1
                    continue
            rec = run_cell(arch, shape, mk, tag=args.tag, remat_override=args.remat,
                           variant=args.variant, results=results)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
