"""On the card only (``python3 -m pytest -m card perfbench`` on the GPU
machine): one short run of every cell through ``run.py``, correct, with
its metrics; skipped where there is no card."""

import json
import pathlib
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.card
@pytest.mark.parametrize("name", harness.cell_names())
def test_a_short_run_is_correct(card, name):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                        str(2**31 + 77), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in harness.load_cell(name).end_to_end}
    assert res["device"]["platform"] == "gpu"
