"""Roofline terms of every dry-run cell against the H100 (the port of
``repro.launch.roofline``).

The reference parses the XLA program it compiled for each cell
(``HloCostModel``). Torch compiles no whole program, so the port's cost
comes from running the cell once on the meta device (``launch/dryrun.py``),
the rank-0 view of the production mesh over a fake process group:

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
    products and attention, the ops the reference's dot / convolution
    count covers);
  * collective bytes and counts by kind from the port's collectives (the
    mesh's ``on_collective``: each call's operand bytes and its group),
    each call priced by whether its group fits in one node;
  * an unfused byte upper bound from ``ByteCounter``, a dispatch mode that
    sums each aten op's operand and result bytes (views excluded), as the
    reference's ``hlo_bytes_upper`` sums unfused CPU-HLO ops.

All numbers are PER DEVICE (rank 0's program), so the terms divide by one
card's peaks. The peaks are the H100 SXM's (NVIDIA H100 Tensor Core GPU
datasheet; NVIDIA DGX H100 system architecture):

    compute    = flops / 989e12         (dense bf16 tensor cores)
    memory     = bytes / 3.35e12        (HBM3)
    collective = sum over calls of bytes / link rate: 450e9 a direction
                 over NVLink 4 where the group is within one 8-GPU node,
                 50e9 (400 Gb/s NDR InfiniBand a GPU) where it spans nodes

The memory term is the reference's analytic model (``analytic_memory_bytes``,
copied unchanged with the port's configs); the counted bytes are reported
as an upper bound. Every figure here is an estimate from peaks, not a
measurement.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single|multi] [--tag T]
"""

from __future__ import annotations

import argparse
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Sequence

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 FLOP/s (datasheet)
HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (datasheet)
NVLINK_BW = 450e9  # NVLink 4 bytes/s a direction, within an 8-GPU node (DGX H100)
NET_BW = 50e9  # 400 Gb/s NDR InfiniBand a GPU, across nodes (DGX H100)
GPUS_PER_NODE = 8
HBM_BYTES = 80 * 2**30  # H100 SXM 80 GB

# the port's collective kinds under the reference's HLO names
KIND_NAMES = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
              "ppermute": "collective-permute"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.transcendentals += other.transcendentals * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_count.items():
            self.coll_count[k] = self.coll_count.get(k, 0) + int(v * mult)

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def link_rate(members: Sequence[int]) -> float:
    """Bytes/s of a collective over the global ranks ``members``: NVLink
    where they share one node (ranks laid out ``GPUS_PER_NODE`` a node),
    the network otherwise."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in members}) <= 1 else NET_BW


class CollectiveLog:
    """A mesh's ``on_collective``: bytes and calls by kind (the reference's
    names), bytes within and across nodes, and the priced seconds."""

    def __init__(self):
        self.cost = Cost()
        self.intra_bytes = 0.0
        self.inter_bytes = 0.0
        self.seconds = 0.0

    def __call__(self, kind: str, nbytes: int, members: Sequence[int]) -> None:
        name = KIND_NAMES[kind]
        self.cost.coll_bytes[name] = self.cost.coll_bytes.get(name, 0.0) + nbytes
        self.cost.coll_count[name] = self.cost.coll_count.get(name, 0) + 1
        rate = link_rate(members)
        if rate == NVLINK_BW:
            self.intra_bytes += nbytes
        else:
            self.inter_bytes += nbytes
        self.seconds += nbytes / rate


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def byte_counter():
    """A ``TorchDispatchMode`` whose ``bytes`` sums each aten op's operand
    and result bytes (ops that return a view move nothing and are left
    out): the unfused upper bound of the bytes the ops move."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.ops += 1
                self.bytes += tree_bytes((args, kwargs or {}, out))
            return out

    return ByteCounter()


# ---------------------------------------------------------------------------
# Roofline terms per dry-run cell (the reference's analytic models, with the
# port's configs)
# ---------------------------------------------------------------------------


def model_flops_per_device(arch: str, shape_name: str, mesh_shape: Dict[str, int]) -> float:
    """Analytic MODEL_FLOPS (param-math only): 6ND train / 2ND inference,
    MoE counts active params. Per device = global / chips."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    chips = math.prod(mesh_shape.values())
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / chips


def analytic_memory_bytes(
    arch: str, shape_name: str, mesh_shape: Dict[str, int]
) -> Dict[str, float]:
    """First-order per-device HBM traffic model (bytes/step), the
    reference's: the counted bytes of an unfused run overstate a fused
    program's traffic by the number of unfused hops, so this structural
    model is the memory term (components itemized), with the counted bytes
    reported as an upper bound."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    profile = registry.get_sharding(arch, shape.kind)
    chips = math.prod(mesh_shape.values())
    tp = mesh_shape.get("model", 1)
    P = cfg.param_count()
    P_active = cfg.active_param_count()
    B_loc = max(1, shape.global_batch // (chips // tp))
    S = shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers
    out: Dict[str, float] = {}

    # weights: each device reads its 1/tp slice of the *touched* params per
    # pass (EP MoE: routed experts only ~ active + local share)
    touched = P_active if cfg.moe is not None else P
    w_read = 2.0 * touched / tp  # bf16
    if shape.kind == "train":
        passes = 3.0 if profile.remat == "full" else 2.0
        out["weights"] = w_read * passes
        opt_b = 10.0 if profile.optimizer_dtype == "bfloat16" else 20.0
        n_opt_shards = tp
        for ax in profile.fsdp_axes:
            n_opt_shards *= mesh_shape.get(ax, 1)
        out["optimizer"] = P * (opt_b + 8.0) / n_opt_shards  # m,v r/w + grad r/w
        act_unit = B_loc * S * d * 2.0
        hops = 16.0 if profile.remat == "full" else 24.0
        out["activations"] = act_unit * L * hops
        out["logits"] = B_loc * S * (cfg.vocab_size / tp) * 6.0
    elif shape.kind == "prefill":
        out["weights"] = w_read
        act_unit = B_loc * S * d * 2.0
        out["activations"] = act_unit * L * 8.0
        out["kv_write"] = (
            2.0 * cfg.num_attn_layers * B_loc * S * cfg.kv_dim * 2.0 / max(1, tp)
        )
        out["logits"] = B_loc * 1 * (cfg.vocab_size / tp) * 6.0  # last-token only
    else:  # decode
        out["weights"] = w_read
        cache_elems = 2.0 * cfg.num_attn_layers * shape.global_batch * S * cfg.kv_dim
        out["kv_read"] = cache_elems * 2.0 / chips  # bf16 cache, fully sharded
        if cfg.ssm is not None:
            s = cfg.ssm
            if cfg.family == "ssm":  # the reference's ssm.kind "rwkv6" (the port keeps no kind)
                H = d // s.head_dim
                st = L * shape.global_batch * H * s.head_dim * s.head_dim * 4.0
            else:
                d_in = s.expand * d
                st = L * shape.global_batch * (d_in // s.head_dim) * s.head_dim * s.state_dim * 4.0
            out["ssm_state"] = 2.0 * st / chips  # read + write
        out["activations"] = shape.global_batch * d * L * 2.0 * 4.0 / (chips // tp)
        out["logits"] = shape.global_batch * (cfg.vocab_size / tp) * 6.0 / max(1, chips // tp)
    return out


def analytic_resident_bytes(
    arch: str, shape_name: str, mesh_shape: Dict[str, int]
) -> Dict[str, float]:
    """Per-device HBM *residency* estimate (the reference's structural
    model): parameters, optimizer state and gradients by their shards, the
    activations a remat "full" step keeps, the KV cache."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    profile = registry.get_sharding(arch, shape.kind)
    chips = math.prod(mesh_shape.values())
    tp = mesh_shape.get("model", 1) if profile.tp_axis else 1
    n_shards = tp
    for ax in profile.fsdp_axes:
        n_shards *= mesh_shape.get(ax, 1)
    n_shards = min(n_shards, chips)
    P = cfg.param_count()
    out: Dict[str, float] = {"params": 2.0 * P / n_shards}
    dp = max(1, chips // tp)
    B_loc = max(1, shape.global_batch // dp)
    S = shape.seq_len
    act_unit = B_loc * S * cfg.d_model * 2.0
    if shape.kind == "train":
        opt_b = 4.0 if profile.optimizer_dtype == "bfloat16" else 8.0
        out["optimizer"] = P * opt_b / n_shards
        out["grads"] = 2.0 * P / n_shards
        # remat=full keeps ~1 activation per layer + working set
        out["activations"] = act_unit * (cfg.num_layers + 8)
        out["logits"] = B_loc * S * cfg.vocab_size / tp * 6.0
    elif shape.kind == "prefill":
        out["activations"] = act_unit * 10
        out["kv_cache"] = (
            2.0 * cfg.num_attn_layers * B_loc * S * cfg.kv_dim * 2.0 / tp
        )
    else:
        out["kv_cache"] = (
            2.0 * cfg.num_attn_layers * shape.global_batch * S * cfg.kv_dim * 2.0 / chips
        )
        out["activations"] = shape.global_batch * cfg.d_model * 2.0 * 8 / dp
    return out


def analyze_cell(json_path: Path) -> Dict:
    """One dry-run record's roofline against the H100 peaks."""
    rec = json.loads(Path(json_path).read_text())
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "ok": rec.get("ok", False),
    }
    if not rec.get("ok"):
        out["error"] = rec.get("error")
        return out
    c = rec["cost"]
    mem = rec.get("memory", {})
    temp = mem.get("temp_bytes")
    hbm_resident = mem.get("argument_bytes", 0) + (temp or 0)
    resident_est = analytic_resident_bytes(rec["arch"], rec["shape"], rec["mesh_shape"])
    mem_parts = analytic_memory_bytes(rec["arch"], rec["shape"], rec["mesh_shape"])
    mem_bytes = sum(mem_parts.values())
    compute_s = c["flops"] / PEAK_FLOPS
    memory_s = mem_bytes / HBM_BW
    coll_s = c["coll_s"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], rec["mesh_shape"])
    step_s = max(terms.values())
    out.update(
        {
            "meta_flops": c["flops"],
            "meta_bytes_upper": c["bytes_upper"],  # unfused upper bound
            "memory_bytes": mem_bytes,
            "memory_parts": {k: round(v) for k, v in mem_parts.items()},
            "collective_bytes": sum(c["coll_bytes"].values()),
            "coll_breakdown": {k: round(v) for k, v in c["coll_bytes"].items()},
            "coll_counts": c["coll_count"],
            "coll_bytes_intra_node": c["coll_bytes_intra_node"],
            "coll_bytes_inter_node": c["coll_bytes_inter_node"],
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": coll_s,
            "dominant": dominant,
            "model_flops_per_device": mf,
            "useful_flops_ratio": mf / c["flops"] if c["flops"] else 0.0,
            "roofline_fraction": (mf / PEAK_FLOPS) / step_s if step_s else 0.0,
            # the rank's argument bytes; the temporaries are not measured on
            # meta, so the fit is unknown (None) unless the record has them
            "hbm_resident_bytes": hbm_resident,
            "fits_hbm_80g": None if temp is None else hbm_resident <= HBM_BYTES,
            "resident_est_bytes": sum(resident_est.values()),
            "resident_est_parts": {k: round(v) for k, v in resident_est.items()},
            "fits_hbm_80g_est": sum(resident_est.values()) <= HBM_BYTES,
            "compile_s": rec.get("compile_s"),
        }
    )
    return out


def default_results() -> Path:
    return Path(__file__).resolve().parents[3] / "results" / "dryrun"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    results = Path(args.results) if args.results else default_results()
    rows = []
    for f in sorted(results.glob(f"*__{args.mesh}{args.tag}.json")):
        try:
            rows.append(analyze_cell(f))
        except Exception as e:  # pragma: no cover
            rows.append({"file": str(f), "error": f"{type(e).__name__}: {e}"})
    outdir = results.parent / "roofline"
    outdir.mkdir(parents=True, exist_ok=True)
    out = Path(args.out) if args.out else outdir / f"roofline_{args.mesh}{args.tag}.json"
    out.write_text(json.dumps(rows, indent=2))
    print("| arch | shape | compute_s | memory_s | collective_s | dominant | "
          "useful% | roofline% | fits80G |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "compute_s" not in r:
            print(f"| {r.get('arch', '?')} | {r.get('shape', '?')} | FAILED: "
                  f"{str(r.get('error'))[:40]} | | | | | | |")
            continue
        print(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{100 * r['useful_flops_ratio']:.0f}% | "
            f"{100 * r['roofline_fraction']:.1f}% | "
            f"{'Y' if r['fits_hbm_80g_est'] else 'N'} |"
        )
    print(f"\nwritten: {out}")


if __name__ == "__main__":
    main()
