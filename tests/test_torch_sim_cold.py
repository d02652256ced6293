"""The port's deterministic simulation on its cold-tier cells, and the CLI's
matrix, against ``repro.sim`` on the CPU (split from
tests/test_torch_sim.py so the two spread over workers): the twins of
tests/test_sim.py's cold-tier cases, the seed-0 ``--check`` cells that reach
the cold tier through both packages, and ``python -m repro_torch.sim --check
--seeds 1 --device cpu``."""

import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import sim as jsim  # noqa: E402
from repro_torch.memory.tiered import ColdTier  # noqa: E402
from repro_torch.sim import SimConfig, run_sim  # noqa: E402
from repro_torch.sim.__main__ import matrix_cells  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_sim import COLD_CELLS, assert_same_report  # noqa: E402

torch.set_num_threads(2)


def _cfg(**kw):
    kw.setdefault("n_ops", 30)
    return SimConfig(**kw)


@pytest.mark.parametrize("tag", COLD_CELLS)
def test_check_matrix_cold_cell_matches_reference(tag):
    """The seed-0 cells of the matrix that spill to the cold tier: the
    port's report equals the reference's, the clean cell cycles the tier
    and shows no violation, the audit cell trips its oracle; both hashes are
    chip_smoke's pins."""
    clean, audit = matrix_cells(0)
    cfg = dict(clean + audit)[tag]
    r = run_sim(cfg, device="cpu")
    assert_same_report(r, jsim.run_sim(jsim.SimConfig(**dataclasses.asdict(cfg))))
    assert chip_smoke.SIM_REF_HASHES[tag[len("s0-"):]] == r.trace_hash
    if cfg.ablate:
        assert {v.oracle for v in r.violations} & chip_smoke.SIM_ORACLES[cfg.ablate[0]]
    else:
        assert r.ok, r.violations[:3]
        assert r.cold_stats["spills"] > r.cold_stats["promotes"] > 0


def test_fault_plans_clean_under_guards_cold_tier():
    """tests/test_sim.py::test_fault_plans_clean_under_guards[cold_tier]:
    capacity victims spilled, exact misses promoted back, and the armed
    spill-wave crashes lost their entries whole on both sides."""
    r = run_sim(_cfg(seed=3, fault="cold_tier"), device="cpu")
    assert r.ok, r.violations[:3]
    assert r.cold_stats["spills"] > 0
    assert r.cold_stats["promotes"] > 0
    assert r.cold_stats["cold_hits"] == r.cold_stats["promotes"]


def test_guard_ablation_is_caught_by_matching_oracle_cold_tier():
    r = run_sim(_cfg(seed=3, fault="cold_tier", ablate=("cold_gc_refcount",)), device="cpu")
    assert r.violations
    assert {v.oracle for v in r.violations} & {"durability"}


def test_cold_tier_plan_clean_deterministic_and_cycling():
    cfg = _cfg(seed=7, fault="cold_tier")
    r = run_sim(cfg, device="cpu")
    assert r.ok, r.violations[:3]
    assert r.config.cold_tier and r.config.n_nodes == 1
    assert r.cold_stats["spills"] > r.cold_stats["promotes"] > 0
    b = run_sim(cfg, device="cpu")
    assert (b.trace_hash, b.span_digest) == (r.trace_hash, r.span_digest)


def test_cold_crash_loses_wave_whole_on_both_sides(tmp_path):
    ct = ColdTier(str(tmp_path))
    ct.arm_crash_after_segment(1)
    ct.spill([("a", 1, None, None, 0.0), ("b", 2, None, None, 0.0)])
    assert len(ct) == 0
    assert ct.fetch(["a", "b"]) == [None, None]
    ct.spill([("c", 3, None, None, 0.0)])
    assert "c" in ct and ct.take(["c"])[0].value == 3

    r = run_sim(_cfg(seed=1, fault="cold_tier"), device="cpu")
    assert r.ok, r.violations[:3]


def test_cli_check_one_seed_exits_zero(tmp_path):
    """``python -m repro_torch.sim --check --seeds 1 --device cpu``: every
    seed-0 cell clean and deterministic, every guard's ablation caught."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.sim", "--check", "--seeds", "1",
                        "--device", "cpu", "--dump-dir", str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "sim-check: 39 cells, 0 red" in p.stdout
    assert not list(tmp_path.iterdir())
