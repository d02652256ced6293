"""The entry point: no card, no result; what it imports holds neither JAX
nor the JAX package, and the reference imports nothing of the program."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = harness.cell_names()[0]
ARGS = ["--workload", CELL, "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=120, env=env)


def _no_result(p):
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    _no_result(p)
    assert "no CUDA device" in p.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}))


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.splitlines()[-1])


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from perfbench import harness, calibrate, judge, tiny\n"
            "from repro_torch.serving.engine import Engine\n"
            "for m in harness.load_cell(harness.cell_names()[0]).per_layer:\n"
            "    harness.load_reader(m['name'])\n"
            "import perfbench.references.dense")
    mods = _modules_after(code)
    assert harness.forbidden_modules(mods) == []
    assert "repro_torch" in {m.split(".")[0] for m in mods}  # whole names: the port passes


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import sys; sys.path[:0] = ['.']\n"
                          "import perfbench.references.dense, perfbench.judge")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.models", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]
