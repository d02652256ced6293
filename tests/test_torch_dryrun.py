"""The port's dry-run (``repro_torch.launch.dryrun``): production cells run
on the meta device as rank 0 of a fake process group of 256 or 512 ranks,
in a subprocess with ``jax`` and ``repro`` refused; their records carry the
reference's keys and give positive roofline terms (``launch/roofline.py``),
and one tensor-parallel cell's collective bytes equal a hand count. Then
the meta route itself: a meta tensor takes the kernels' plain versions and
never reaches the CUDA build, and the model's host reads are skipped on
meta (the token-range check, the grouped MoE's group sizes) and only on
meta."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# one train cell on the multi-pod mesh, one prefill and one decode cell on
# the single-pod mesh
CELLS = [("olmo-1b", "train_4k", "multi"), ("olmo-1b", "prefill_32k", "single"),
         ("qwen3-4b", "decode_32k", "single")]
REF_KEYS = {"arch", "shape", "mesh", "mesh_shape", "tag", "variant", "ok", "lower_s",
            "compile_s", "memory", "cost_analysis", "hlo", "total_s"}

PROBE = r"""
import json, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
from repro_torch.launch import dryrun
out = sys.argv[1]
cells = json.loads(sys.argv[2])
recs = [dryrun.run_cell(a, s, m, results=out) for a, s, m in cells]
print(json.dumps([r["ok"] for r in recs]))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", PROBE, str(out), json.dumps(CELLS)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return {(a, s, m): out / f"{a}__{s}__{m}.json" for a, s, m in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_cell_record_and_roofline(records, cell):
    """ok, the reference's keys, rank 0's argument bytes, no invented temp
    figure; every roofline term positive against the H100 peaks."""
    path = records[cell]
    rec = json.loads(path.read_text())
    assert rec["ok"], rec.get("traceback")
    assert REF_KEYS <= set(rec)
    assert rec["mesh_shape"] == ({"data": 16, "model": 16} if cell[2] == "single"
                                 else {"pod": 2, "data": 16, "model": 16})
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] is None
    row = roofline.analyze_cell(path)
    for term in ("compute_s", "memory_s", "collective_s", "meta_flops", "memory_bytes",
                 "model_flops_per_device", "resident_est_bytes"):
        assert row[term] > 0, term
    assert row["dominant"] in ("compute", "memory", "collective")
    assert 0 < row["roofline_fraction"] <= 1
    assert row["fits_hbm_80g"] is None


def test_tp_layer_collectives_match_hand_count(records):
    """olmo-1b prefill_32k on (16, 16), its serving profile: tensor parallel
    over model, the batch over data. Rank 0 holds 2 of the 32 rows. Each
    layer ends attention and the MLP in one all-reduce of its (2, 32768,
    2048) bf16 partial sums; the vocabulary-parallel embedding adds one more;
    the head's columns are all-gathered once. Every group spans two 8-GPU
    nodes (16 consecutive ranks), so all of it is priced on the network."""
    cfg = registry.get("olmo-1b")
    rec = json.loads(records[("olmo-1b", "prefill_32k", "single")].read_text())
    B, S, D, tp = 32 // 16, 32_768, cfg.d_model, 16
    act = B * S * D * 2
    c = rec["cost"]
    assert c["coll_count"] == {"all-reduce": 2 * cfg.num_layers + 1, "all-gather": 1}
    assert c["coll_bytes"]["all-reduce"] == (2 * cfg.num_layers + 1) * act
    assert c["coll_bytes"]["all-gather"] == B * S * (cfg.vocab_size // tp) * 2
    assert c["coll_bytes_intra_node"] == 0
    assert c["coll_s"] == pytest.approx(sum(c["coll_bytes"].values()) / roofline.NET_BW)


# ---------------------------------------------------------------------------
# The meta route
# ---------------------------------------------------------------------------


def _no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a meta tensor reached the CUDA build of {name}")

    monkeypatch.setattr(_build, "entry", refuse)


@pytest.mark.parametrize("arch", ["olmo-1b", "kimi-k2-1t-a32b", "rwkv6-3b", "zamba2-2.7b"])
def test_meta_model_reaches_no_kernel(monkeypatch, arch):
    """A smoke model's prefill and a decode step on meta tensors: every
    attention and scan call takes its plain version (the CUDA build is never
    asked for), and the results are meta tensors of the right shapes."""
    _no_build(monkeypatch)
    cfg = registry.get_smoke(arch)
    params = lm.abstract_params(cfg)
    toks = torch.empty((2, 9), dtype=torch.int32, device="meta")
    logits, cache = lm.prefill(cfg, params, toks, cache_len=10)
    assert logits.device.type == "meta" and logits.shape == (2, 9, cfg.vocab_size)
    dec, _ = lm.decode_step(cfg, params, cache, toks[:, :1])
    assert dec.device.type == "meta" and dec.shape == (2, 1, cfg.vocab_size)


def test_meta_skips_host_reads_and_cpu_does_not(monkeypatch):
    """The grouped MoE reads its group sizes on the host; on meta (no values)
    it runs the rows as an even load instead, and on the CPU never does;
    the token-range check reads no meta value."""
    cfg = dataclasses.replace(registry.get_smoke("kimi-k2-1t-a32b"), dtype="float32",
                              param_dtype="float32")
    calls = []
    even = moe._even_ffn

    def spy(*a, **kw):
        calls.append(a[2].device.type)
        return even(*a, **kw)

    monkeypatch.setattr(moe, "_even_ffn", spy)
    p = lm.abstract_params(cfg)["blocks"][0]["moe"]
    y, aux = moe.moe_forward_grouped(cfg, p, torch.empty((2, 5, cfg.d_model), device="meta"))
    assert y.device.type == "meta" and y.shape == (2, 5, cfg.d_model) and calls == ["meta"]
    pc = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")["blocks"][0]["moe"]
    y, aux = moe.moe_forward_grouped(cfg, pc, torch.randn(2, 5, cfg.d_model))
    assert torch.isfinite(y).all() and calls == ["meta"]
    # the token-range check: skipped on meta, raises on a CPU id out of range
    lm._check_ids(cfg, torch.full((1, 3), cfg.vocab_size, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="outside the vocabulary"):
        lm._check_ids(cfg, torch.full((1, 3), cfg.vocab_size, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The card run's pieces on the CPU: the shard materialiser, the record's
# measured fit, the refusal without a card
# ---------------------------------------------------------------------------

from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.distributed.mesh_compat import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 16, 8, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 32, 4, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 32, 8, "decode")}
MATERIALISED = [(a, s) for a in ("olmo-1b", "qwen2-vl-7b", "kimi-k2-1t-a32b", "zamba2-2.7b",
                                 "whisper-tiny") for s in SMALL_SHAPES]


@pytest.fixture
def smoke_cells(monkeypatch):
    """``build_cell`` on the smoke configs and small shapes (the production
    ones cannot run on a CPU)."""
    smoke = {a: registry.get_smoke(a) for a in registry.ARCH_NAMES}
    monkeypatch.setattr(registry, "get", smoke.__getitem__)
    for name, shape in SMALL_SHAPES.items():
        monkeypatch.setitem(SHAPES, name, shape)
    return smoke


@pytest.mark.parametrize("cell", MATERIALISED, ids=lambda c: "-".join(c))
def test_materialised_shards_are_the_meta_shards(smoke_cells, cell):
    """At a smoke arch on a (2, 4) mesh of a fake world of 8: the shards
    ``materialize`` draws have the meta shards' shapes and dtypes, tensor by
    tensor, and exactly their argument bytes; norm scales are 1, ids lie in
    the vocabulary, the decode cache is filled to the cell's seq_len; and
    the step runs on them (here on the CPU, where the wrappers take their
    plain versions) to the meta run's output shapes."""
    arch, shape = cell
    cfg, sc = smoke_cells[arch], SMALL_SHAPES[shape]
    with dryrun.fake_world(8):
        meta_step, meta_args = dryrun.build_cell(arch, shape, Mesh((2, 4), ("data", "model"),
                                                                   device="meta"))
        step, shards = dryrun.build_cell(arch, shape, Mesh((2, 4), ("data", "model"),
                                                           device="cpu"))
        args = dryrun.materialize(shards, sc.kind, cfg, sc.seq_len, torch.device("cpu"),
                                  torch.Generator().manual_seed(0))
        want, got = list(roofline._tensors(meta_args)), list(roofline._tensors(args))
        assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype)
                                                           for t in want]
        assert all(t.device.type == "cpu" for t in got)
        assert roofline.tree_bytes(args) == roofline.tree_bytes(meta_args)
        scales = []
        dryrun._fill(args[0], lambda path, t: scales.append(t) if str(path[-1]).endswith(
            "scale") else None)
        assert all(torch.equal(t, torch.ones_like(t)) for t in scales)
        assert bool(scales) == (cfg.norm_type != "layernorm_np")
        batch = args[-1]
        for key in ("tokens", "labels"):
            if key in batch:
                assert 0 <= int(batch[key].min()) and int(batch[key].max()) < cfg.vocab_size
        if sc.kind == "decode":
            assert args[1]["length"] == sc.seq_len
            assert args[1]["max_len"] == meta_args[1]["max_len"]
        out, meta_out = step(*args), meta_step(*meta_args)
        assert ([tuple(t.shape) for t in roofline._tensors(out)]
                == [tuple(t.shape) for t in roofline._tensors(meta_out)])


def test_reset_counts_clears_what_another_device_left():
    """The meta run leaves the EP path's dropped-pair count as a meta
    tensor, which a CUDA count cannot be added to: each run starts from 0."""
    from repro_torch.kernels.flash_attention import flash_attention

    moe.moe_forward_ep.dropped = torch.zeros((), device="meta")
    flash_attention.launches = 3
    flash_attention.launches_by_hd[128] += 3
    launchers = dryrun.reset_counts()
    assert moe.moe_forward_ep.dropped == 0 and flash_attention.launches == 0
    assert not flash_attention.launches_by_hd
    assert list(launchers) == list(kernels.KERNELS)
    assert launchers["flash_attention"] is flash_attention


def test_new_bytes_leaves_out_arguments_updated_in_place():
    """Output bytes as ``output_bytes`` counts them: a view's own elements
    (its base is a temporary, as the prefill's logits behind
    ``logits[:, -1]``), each tensor once, arguments updated in place left
    out."""
    a, b = torch.zeros(10), torch.zeros(4)
    a.add_(1)
    base = torch.zeros(8)
    view = base[:2]
    assert dryrun.new_bytes((a, {"x": b}), (a, b)) == 0
    assert dryrun.new_bytes((a, view), (a,)) == 2 * 4 == roofline.tree_bytes(view)
    assert dryrun.new_bytes((view, view), ()) == 2 * 4
    assert dryrun.new_bytes((view, base[2:4]), ()) == 2 * 2 * 4
    assert dryrun.new_bytes((base[:2], base[:2]), ()) == 2 * 4  # one tensor, twice


def test_cuda_device_raises_without_a_card(tmp_path):
    """``--device cuda`` never falls back to meta: without a card both the
    function and the CLI raise before any record is written."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("olmo-1b", "decode_32k", "single", results=tmp_path, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--device", "cuda",
                     "--results", str(tmp_path)])
    with pytest.raises(ValueError, match="meta or cuda"):
        dryrun.run_cell("olmo-1b", "decode_32k", "single", results=tmp_path, device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_fit_comes_from_a_card_measurement(records, tmp_path):
    """``analyze_cell`` leaves ``fits_hbm_80g`` None on a meta record, reads
    it from ``peak_bytes`` against 80 GB on a measured one, and false on an
    out-of-memory reading; the estimate stays beside it."""
    rec = json.loads(records[("qwen3-4b", "decode_32k", "single")].read_text())
    cases = {"meta": ({}, None),
             "fits": ({"peak_bytes": roofline.HBM_BYTES, "temp_bytes": 1, "oom": False}, True),
             "over": ({"peak_bytes": roofline.HBM_BYTES + 1, "temp_bytes": 1, "oom": False},
                      False),
             "oom": ({"peak_bytes": None, "temp_bytes": None, "oom": True}, False)}
    for name, (mem, want) in cases.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(dict(rec, memory=dict(rec["memory"], **mem))))
        row = roofline.analyze_cell(path)
        assert row["fits_hbm_80g"] is want, name
        assert row["peak_bytes"] == mem.get("peak_bytes")
        assert row["fits_hbm_80g_est"] is True


def test_chip_smoke_card_cells_and_their_check():
    """``chip_smoke.py``'s phase 11(c): its cells are dry-run cells, and its
    check takes a measured record with the path's kernel once a layer and
    refuses one launch short, no temporaries, or a peak past 80 GB."""
    import chip_smoke

    assert set(chip_smoke.CARD_DRYRUN_CELLS) <= {(a, s, m) for a, s in registry.all_cells()
                                                for m in ("single", "multi")}

    def cell(arch, shape, **kw):
        launches = {k: 0 for k in kernels.KERNELS}
        if shape in chip_smoke.CARD_DRYRUN_KERNEL:
            launches[chip_smoke.CARD_DRYRUN_KERNEL[shape]] = registry.get(arch).num_layers
        return dict({"cell": [arch, shape, "single"], "oom": False, "temp_bytes": 1 << 30,
                     "peak_bytes": 8 << 30, "fits_hbm_80g": True, "launches": launches}, **kw)

    good = [cell(a, s) for a, s, _ in chip_smoke.CARD_DRYRUN_CELLS]
    chip_smoke.check_card_dryrun({"cells": good})
    short = cell("olmo-1b", "prefill_32k")
    short["launches"]["flash_attention"] -= 1
    for bad in (short, cell("qwen3-4b", "decode_32k", temp_bytes=0),
                cell("olmo-1b", "train_4k", peak_bytes=roofline.HBM_BYTES + 1),
                cell("olmo-1b", "train_4k", oom=True, peak_bytes=None, temp_bytes=None)):
        with pytest.raises(AssertionError, match="multi\\(c\\)"):
            chip_smoke.check_card_dryrun({"cells": good[:1] + [bad]})
