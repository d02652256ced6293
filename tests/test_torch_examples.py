"""The example drivers' twins (``repro_torch.examples``) on the CPU against
the reference's scripts (``examples/*.py``), each run as a process of its
own, all at once: the port's with ``jax`` and ``repro`` refused.

* ``quickstart`` and ``distributed_cache_demo`` (host only) print the
  reference's lines; the one exception is a quickstart row's latency, to
  which every caching method adds its lookups' measured time (both
  packages), so no two runs need agree on it. Its simulated part is held
  exactly instead: the twin's (its ``latency split:`` on stderr), the
  reference's (its records, in process) and
  ``chip_smoke.QUICKSTART_SIMULATED_S`` are equal, and each printed
  latency is at least its simulated part.
* ``serve_agent --n 2`` (``chip_smoke.EXAMPLE_SERVE_N``; smoke widths)
  prints the reference's per-task lines and summary, the wall left out.
* ``train_small --steps 12``: the same steps and fault events, a falling
  loss in both; the losses themselves differ (the weights are drawn by a
  torch generator, not a JAX key), the first within 0.02 of the
  reference's (both near ln 512).

``chip_smoke.py``'s phase-12 pins are these reference outputs."""

import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    distributed_cache_demo,
    quickstart,
    serve_agent,
    train_small,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SERVE_N, TRAIN_STEPS = chip_smoke.EXAMPLE_SERVE_N, 12

PORT = r"""
import runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""

RUNS = {
    "quickstart": ((), ()),
    "distributed_cache_demo": ((), ()),
    "serve_agent": (("--n", str(SERVE_N)), ("--n", str(SERVE_N))),
    "train_small": (("--steps", str(TRAIN_STEPS)), ("--steps", str(TRAIN_STEPS))),
}


@pytest.fixture(scope="module")
def outputs():
    """{name: (reference's lines, port's lines, port's stderr)}, every run
    started at once."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name, (ref_args, port_args) in RUNS.items():
        procs[name] = (
            subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
                              *ref_args], env=env, cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            subprocess.Popen([sys.executable, "-c", PORT, f"repro_torch.examples.{name}",
                              *port_args, "--device", "cpu"], env=env, cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = {}
    try:
        for name, pair in procs.items():
            got = []
            for proc in pair:
                stdout, stderr = proc.communicate(timeout=600)
                assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
                got.append(stdout.splitlines())
            out[name] = (*got, stderr)
    finally:
        for pair in procs.values():
            for proc in pair:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    return out


def _latencies(lines):
    """(``lines`` with each method row's latency column blanked, {method:
    its printed latency})."""
    rest, lat = [], {}
    for line in lines:
        cols = line.split()
        if len(cols) == 5 and cols[0] in chip_smoke.QUICKSTART_SIMULATED_S:
            lat[cols[0]] = float(cols[3])
            line = " ".join(cols[:3] + cols[4:])
        rest.append(line)
    return rest, lat


@pytest.fixture(scope="module")
def reference_simulated():
    """The reference's simulated latency of each quickstart method: its
    records' latency less their measured lookup time, in process."""
    from repro.core.harness import METHODS, run_workload

    return {m: sum(x.latency_s - x.cache_lookup_s
                   for x in run_workload("financebench", m, quickstart.N,
                                         keep_records=True).records)
            for m in METHODS}


def test_quickstart_prints_the_references_lines(outputs, reference_simulated):
    ref, port, err = outputs["quickstart"]
    assert len(ref) == 10
    (ref_rest, ref_lat), (port_rest, _) = _latencies(ref), _latencies(port)
    assert port_rest == ref_rest == _latencies(chip_smoke.QUICKSTART_LINES)[0]
    # the card's pins: the reference's lines, the simulated latency of both
    tol = chip_smoke.QUICKSTART_SIMULATED_TOL
    assert reference_simulated.keys() == chip_smoke.QUICKSTART_SIMULATED_S.keys()
    for m, sim in chip_smoke.QUICKSTART_SIMULATED_S.items():
        assert abs(reference_simulated[m] - sim) <= tol, m
        assert ref_lat[m] >= sim - 0.05 - tol, m  # lookups only add
    split = chip_smoke.check_quickstart(port, err)
    assert split["accuracy_optimal"]["lookup_s"] == 0.0


def test_quickstart_check_refuses_a_wrong_simulated_latency(outputs):
    """The card's check holds the simulated part to its pin and the printed
    latency to the two parts' sum, and refuses a line that is missing."""
    _, port, err = outputs["quickstart"]
    split = json.loads(err.split("latency split: ", 1)[1].splitlines()[0])
    for method, key, delta in (("cascade", "simulated_s", 1e-3), ("semantic", "lookup_s", 0.1)):
        bad = json.loads(json.dumps(split))
        bad[method][key] += delta
        with pytest.raises(AssertionError, match="quickstart"):
            chip_smoke.check_quickstart(port, "latency split: " + json.dumps(bad))
    with pytest.raises(AssertionError, match="quickstart"):
        chip_smoke.check_quickstart(port, "")
    with pytest.raises(AssertionError, match="quickstart"):
        chip_smoke.check_quickstart(port[:-1], err)


def test_distributed_cache_demo_prints_the_references_lines(outputs):
    ref, port, _ = outputs["distributed_cache_demo"]
    assert port == ref and len(ref) == 13
    assert list(chip_smoke.DCACHE_DEMO_LINES) == ref


def _no_wall(lines):
    return [re.sub(r"  wall=[0-9.]+s$", "", x) for x in lines]


def test_serve_agent_summary_matches_reference(outputs):
    """The per-task lines (keyword, hit, correct), n, accuracy, hit rate,
    cost and the tokens each engine served; the tiers line and the wall
    differ by design (the port names the device, a wall is a wall)."""
    ref, port, _ = outputs["serve_agent"]
    assert port[0].startswith("tiers: large=nemotron-4-15b  small=olmo-1b  actor=qwen2.5-3b")
    assert _no_wall(port[1:]) == _no_wall(ref[1:])
    assert re.search(r"  wall=[0-9.]+s$", port[-2])
    assert list(chip_smoke.SERVE_AGENT_LINES) == _no_wall(ref[1:])


def test_train_small_summary_matches_reference(outputs):
    ref, port, _ = outputs["train_small"]
    assert port[0] == ref[0] == "training qwen2.5-3b-smoke: 0.4M params"
    assert port[-2] == ref[-2] == (f"completed {TRAIN_STEPS} steps; injected faults handled: "
                                   f"[({TRAIN_STEPS // 2}, 'nan')]")
    first = [float(re.match(r"loss ([0-9.]+) -> ([0-9.]+) \((.*)\)", x[-1])[1])
             for x in (ref, port)]
    assert port[-1].endswith("(OK: decreased)") and ref[-1].endswith("(OK: decreased)")
    assert abs(first[0] - first[1]) < 0.02, first


@pytest.mark.parametrize("mod", [quickstart, distributed_cache_demo, serve_agent, train_small],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_twin_without_a_card_raises(mod):
    """The card unless ``--device cpu`` is asked for: without CUDA the
    default raises before any work, and nothing falls back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
