"""The traffic generator: a seed repeats exactly, every seed serves the
same sizes in another order, and the waves match the cells' files."""

import json
import pathlib

import numpy as np
import pytest

from perfbench import harness
from perfbench.traffic import Traffic, check_params

HERE = pathlib.Path(__file__).resolve().parent
CELLS = harness.cell_names()
BIG_SEED = 2**31 + 12345  # seeds may pass 32 signed bits


@pytest.mark.parametrize("name", CELLS)
def test_a_seed_repeats_exactly(name):
    cell = harness.load_cell(name)
    a, b = (Traffic(cell.traffic, cell.conf["vocab_size"], BIG_SEED) for _ in range(2))
    for w in range(10):
        np.testing.assert_array_equal(a.prompts(w), b.prompts(w))
    np.testing.assert_array_equal(a.warm_prompts(a.lengths[0]), b.warm_prompts(b.lengths[0]))
    lens = [a.prompts(w).shape[1] for w in range(10)]
    assert a.sample(lens) == b.sample(lens)
    c = Traffic(cell.traffic, cell.conf["vocab_size"], BIG_SEED + 1)
    assert not np.array_equal(a.prompts(0), c.prompts(0))


@pytest.mark.parametrize("name", CELLS)
def test_waves_match_the_cell_files(name):
    cell = harness.load_cell(name)
    p = cell.traffic
    check_params(p)
    t = Traffic(p, cell.conf["vocab_size"], 7)
    lo, hi = p["suffix_tokens"]
    n = len(t.lengths)
    for w in range(2 * n):
        x = t.prompts(w)
        assert x.dtype == np.int32 and x.shape[0] == p["concurrency"]
        assert lo <= x.shape[1] - p["prefix_tokens"] <= hi
        assert x.min() >= 0 and x.max() < cell.conf["vocab_size"]
        # the system prompt: the same ids in every call of every wave
        assert (x[:, :p["prefix_tokens"]] == t.prefix).all()
    assert t.lengths[0] == lo and t.lengths[-1] == hi and n == p["lengths_per_block"]
    assert t.warm_prompts(hi).shape == (p["concurrency"], t.longest_prompt)
    assert t.max_len == p["prefix_tokens"] + hi + p["max_new"]


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_serves_the_same_sizes_in_another_order(name):
    cell = harness.load_cell(name)
    orders = []
    for seed in (1, 2, BIG_SEED):
        t = Traffic(cell.traffic, cell.conf["vocab_size"], seed)
        n = len(t.lengths)
        for block in range(3):
            got = [t.suffix_len(block * n + i) for i in range(n)]
            assert sorted(got) == t.lengths
        orders.append([t.suffix_len(i) for i in range(n)])
    assert len({tuple(o) for o in orders}) > 1


def test_sample_holds_the_longest_call_and_no_repeats():
    cell = harness.load_cell(CELLS[0])
    t = Traffic(cell.traffic, cell.conf["vocab_size"], 3)
    lens = [10, 40, 20, 40]
    s = t.sample(lens)
    assert s[0] == (1, 0)
    assert len(s) == len(set(s)) == cell.traffic["check_rows"]
    assert all(0 <= w < 4 and 0 <= r < t.concurrency for w, r in s)


def test_traffic_files_are_data():
    for f in (HERE / "traffic").iterdir():
        assert f.suffix == ".json"
        check_params(json.loads(f.read_text()))
