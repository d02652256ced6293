"""``BENCHMARK.json`` and the files it names: the allowed characters and
keys, one file for every configuration, cell, traffic mix and metric, and
every configuration held to the port's."""

import json
import pathlib
import re

import pytest

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert not (ROOT / word).exists() or word.startswith("perfbench/")


@pytest.mark.parametrize("entry", METRICS + BENCH["configs"] + BENCH["workloads"],
                         ids=lambda e: e["name"])
def test_names_and_units_use_the_allowed_characters(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_are_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(m) <= keys and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    reader = harness.load_reader(m["name"])
    assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"])
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} - {"setup_s"}
        assert cell.per_layer and w["chips"] in (1, 4)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_match_the_port(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"perfbench/configs/{c['name']}.json"
    conf = json.loads((ROOT / c["file"]).read_text())
    assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
    harness.model_config(conf)  # raises on any width that differs
    assert (HERE / "references" / f"{conf['reference']}.py").exists()


def test_a_width_that_differs_is_refused():
    conf = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    conf["hidden_size"] += 128
    with pytest.raises(ValueError, match="hidden_size"):
        harness.model_config(conf)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    cell = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
    assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert cell["limits"]["max_logit_gap"] is not None
