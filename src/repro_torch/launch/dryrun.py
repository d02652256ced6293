"""Multi-pod dry-run: every (arch x shape) cell on the production meshes, on
the meta device, with its FLOPs, bytes and collectives counted, and with
``--device cuda`` its memory measured on the card (the port of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cuda

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
rank 0's shapes; the meta run needs no card and touches none.

Meta tensors hold no storage, so the temporaries cannot be counted there.
With ``--device cuda`` each cell then runs a second time, for memory only,
under the same fake process group: a live mesh on the card, rank 0's
shards of the same shapes and dtypes allocated there (``materialize``:
drawn from a generator seeded per cell), and the step run once between
``reset_peak_memory_stats`` and ``max_memory_allocated``. That run takes
the hand-written kernels at the rank's shapes (flash at S = 32,768, decode
over a 32,768-token cache, the scans); the counts stay the meta run's
(``FlopCounterMode`` cannot see a custom kernel). The fake group moves no
data (an all-gather leaves ``empty_like`` memory), so the card run's values
are not data: it checks no logit and no loss, only that the step runs and
what it allocates. ``--device cuda`` without a card raises; it never falls
back to meta. With ``--all``, and only there, an allocator
``OutOfMemoryError`` is that cell's reading (``fits_hbm_80g`` false, the
allocator's message in ``temp_note``).

Each record goes to ``results/dryrun/<arch>__<shape>__<mesh><tag>.json``
with the reference's keys. ``memory.argument_bytes`` is the exact bytes of
rank 0's shards and ``output_bytes`` those of the step's results; on meta
``temp_bytes`` is null and ``temp_note`` says why. A card run adds
``peak_bytes`` (the allocator's high-water mark over the step),
``base_bytes`` (allocated before it), ``temp_bytes`` (peak less the
argument bytes and the output bytes, floored at 0; ``CARD_TEMP_NOTE``),
``measured_on`` (the card's name and power limit) and each kernel's
``launches`` in the step. There is no compiled program: ``hlo`` is null,
``lower_s`` is the time to build the shards and ``compile_s`` the time of
the counted run. The process group lives only inside ``run_cell``; nothing
is initialised at import. The cells run one after another in this process,
each cell's tensors and cuBLAS's workspaces freed before the next; the card
part of a cell holds an exclusive lock on ``<results>/.card.lock``, so
another process sharing the card can hold it off.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
import traceback
import zlib
from pathlib import Path

from repro_torch import kernels
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"
TEMP_NOTE = ("not measured: meta tensors hold no storage and the port compiles no "
             "program whose buffers could be counted")
CARD_TEMP_NOTE = ("measured on the card: the allocator's high-water mark over one step "
                  "(max_memory_allocated) less the argument bytes and the output bytes as "
                  "output_bytes counts them (a view's own elements; results that are "
                  "arguments updated in place left out), floored at 0; the storage behind a "
                  "view, such as the prefill's (B, S, V) logits behind logits[:, -1], is "
                  "temporary; the port's allocator reading, not XLA's buffer assignment")


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

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            inputs = {k: v for k, v in batch.items() if k != "tokens"}
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


def _fill(tree, leaf, path=()):
    """``tree`` with each tensor leaf replaced by ``leaf(path, tensor)``."""
    if isinstance(tree, dict):
        return {k: _fill(v, leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, leaf, path + (i,)) for i, v in enumerate(tree))
    return leaf(path, tree) if hasattr(tree, "is_meta") else tree


def materialize(args, kind: str, cfg, seq_len: int, device, generator):
    """Rank 0's meta shards ``args`` (``build_cell``'s, for a cell of
    ``kind``) as tensors of the same shapes and dtypes on ``device``, drawn
    from ``generator`` (on ``device``): weights 0.02 * N(0, 1), norm scales
    1 and biases 0; the optimizer state 0; token ids and labels uniform in
    the vocabulary, M-RoPE positions 0..S-1, embeddings and frames N(0, 1);
    the decode cache's tensors 0.02 * N(0, 1) and its ``length`` the cell's
    ``seq_len`` (a cache of ``input_specs``' seq_len + DECODE_HEADROOM
    slots, filled to seq_len)."""
    import torch

    def draw(t, scale):
        w = torch.randn(tuple(t.shape), generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(t.dtype)

    def weight(path, t):
        name = str(path[-1]) if path else ""
        if not t.is_floating_point():
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if name.endswith("scale"):
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        if name.endswith("bias"):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return draw(t, 0.02)

    def zero(path, t):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    def batch_leaf(path, t):
        name = path[-1]
        if name == "positions":  # (3, B, S) M-RoPE ids
            pos = torch.arange(t.shape[-1], dtype=t.dtype, device=device)
            return pos.expand(tuple(t.shape)).contiguous()
        if not t.is_floating_point():
            return torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=generator,
                                 dtype=t.dtype, device=device)
        return draw(t, 1.0)

    if kind == "train":
        params, opt, batch = args
        return (_fill(params, weight), _fill(opt, zero), _fill(batch, batch_leaf))
    if kind == "prefill":
        params, batch = args
        return _fill(params, weight), _fill(batch, batch_leaf)
    params, cache, batch = args
    cache = dict(_fill(cache, lambda p, t: draw(t, 0.02) if t.is_floating_point()
                       else zero(p, t)), length=seq_len)
    return _fill(params, weight), cache, _fill(batch, batch_leaf)


def new_bytes(out, args) -> int:
    """Bytes of the tensors of ``out`` as ``roofline.tree_bytes`` counts them
    (a view's own elements, not its base's), each distinct tensor once,
    less those whose storage is an argument's (results written into an
    argument in place are counted as arguments)."""
    from repro_torch.launch.roofline import _tensors

    held = {t.untyped_storage().data_ptr() for t in _tensors(args)}
    seen, total = set(), 0
    for t in _tensors(out):
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        if t.untyped_storage().data_ptr() not in held and key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def card_lock(results: Path):
    """The card to this process alone (an exclusive lock on
    ``<results>/.card.lock``) while the block runs."""
    import fcntl

    results.mkdir(parents=True, exist_ok=True)
    with open(results / ".card.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def card_name() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the current card, or
    torch's device name where nvidia-smi is missing."""
    import torch

    idx = torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={idx}"],
                             capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(idx)


def reset_counts() -> dict:
    """Every kernel's launch counters (``kernels.reset_counts``), and the EP
    path's count of dropped pairs, set to 0 before a run (a count a run on
    another device left cannot add to this run's: a meta tensor does not
    add to a CUDA one). Returns the kernels' launchers by name."""
    from repro_torch.models import moe

    moe.moe_forward_ep.dropped = 0
    return kernels.reset_counts()


def measure_card(arch: str, shape_name: str, mesh_shape, *, seed: int,
                 remat_override=None, variant: str = "", oom_is_reading: bool = False) -> dict:
    """The cell's step once on the card under the current (fake) process
    group: rank 0's shards materialised on the card, the allocator's peak
    over the step and each kernel's launches (``memory`` keys of the
    record). With ``oom_is_reading`` an ``OutOfMemoryError`` is the
    reading (``oom``); otherwise it propagates."""
    import gc

    import torch

    from repro_torch.distributed.mesh_compat import Mesh
    from repro_torch.launch import roofline

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = SHAPES[shape_name].kind
    mesh = Mesh(mesh_shape.devices.shape, mesh_shape.axis_names, device=dev)
    step, meta_args = build_cell(arch, shape_name, mesh, remat_override=remat_override,
                                 variant=variant)
    cfg = registry.get(arch)  # the variants change no vocabulary
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec = {"measured_on": card_name(), "temp_note": CARD_TEMP_NOTE}
    args = out = None
    try:
        args = materialize(meta_args, kind, cfg, SHAPES[shape_name].seq_len, dev, gen)
        del meta_args
        arg_bytes = roofline.tree_bytes(args)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        launchers = reset_counts()
        out = step(*args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        rec.update(peak_bytes=peak, base_bytes=base, card_argument_bytes=arg_bytes,
                   temp_bytes=max(0, peak - arg_bytes - new_bytes(out, args)), oom=False,
                   launches={k: fn.launches for k, fn in launchers.items()})
    except torch.cuda.OutOfMemoryError as e:
        if not oom_is_reading:
            raise
        rec.update(peak_bytes=None, temp_bytes=None, oom=True,
                   temp_note=f"out of memory on the card: {str(e).strip()[:600]}")
    finally:
        args = out = step = None
        gc.collect()
        # cuBLAS keeps its workspaces (64 MiB on the H100) for the process:
        # freed here, each cell starts from what a fresh process holds
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, tag: str = "",
             remat_override=None, variant: str = "", results: Path = None,
             device: str = "meta", oom_is_reading: bool = False) -> dict:
    from repro_torch.distributed.mesh_compat import Mesh
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_production_mesh

    if device not in ("meta", "cuda"):
        raise ValueError(f"dry-run device {device!r}: meta or cuda")
    if device == "cuda":
        from repro_torch.models.common import resolve_device

        resolve_device("cuda")  # raises without a card: never falls back to meta
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
            reset_counts()
            out, cost = measure(step, args, log)
            t2 = time.time()
            rec["memory"] = {
                "argument_bytes": roofline.tree_bytes(args),
                "output_bytes": roofline.tree_bytes(out),
                "temp_bytes": None,
                "generated_code_bytes": None,
                "temp_note": TEMP_NOTE,
            }
            del step, args, out
            if device == "cuda":
                seed = zlib.crc32(f"{arch}|{shape_name}|{mesh_kind}{tag}".encode())
                with card_lock(results):
                    t3 = time.time()
                    rec["memory"].update(measure_card(
                        arch, shape_name, shape, seed=seed, remat_override=remat_override,
                        variant=variant, oom_is_reading=oom_is_reading))
                    rec["card_s"] = round(time.time() - t3, 2)
        rec["lower_s"] = round(t1 - t0, 2)
        rec["compile_s"] = round(t2 - t1, 2)
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
    mem = rec.get("memory", {})
    if mem.get("oom"):
        status += ", out of memory on the card"
    elif mem.get("peak_bytes") is not None:
        status += f", peak {mem['peak_bytes'] / 2**30:.2f} GiB on the card"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}{tag}: {status} "
          f"in {rec['total_s']}s", flush=True)
    return rec


def main(argv=None):
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
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: the counted run only (default); cuda: also each cell's "
                    "memory measured on the card")
    args = ap.parse_args(argv)
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
                           variant=args.variant, results=results, device=args.device,
                           oom_is_reading=args.all)
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
