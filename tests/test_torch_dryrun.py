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
