"""The plain reference against the port's CPU path at a tiny width: the
same logits in float32, and the CPU Engine's greedy tokens within the
tiny limit in bf16."""

import dataclasses

import pytest
import torch

from perfbench import harness, judge, tiny, weights
from perfbench.references import dense
from perfbench.traffic import Traffic

CELLS = harness.cell_names()


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("name", CELLS)
def test_reference_logits_equal_the_ports_in_float32(name):
    from repro_torch.models import lm

    cell, cfg = tiny.cell(name)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = _fp32(weights.make(cell.conf, 5, "cpu"))
    toks = torch.randint(0, cell.conf["vocab_size"], (2, 37),
                         generator=torch.Generator().manual_seed(1))
    ours, _, _ = lm.forward(cfg, params, toks)
    ref = dense.logits(cell.conf, params, list(toks), [range(37)] * 2)
    for b in range(2):
        torch.testing.assert_close(ref[b], ours[b].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_cpu_engine_tokens_sit_within_the_limit(name):
    from repro_torch.serving.engine import Engine

    cell, cfg = tiny.cell(name)
    for seed in (2, 3):
        params = weights.make(cell.conf, seed, "cpu")
        t = Traffic(cell.traffic, cell.conf["vocab_size"], seed)
        eng = Engine(cfg, params, max_len=t.max_len, device="cpu")
        kept = [(t.prompts(w), None) for w in range(3)]
        kept = [(p, eng.generate(p, max_new=t.max_new)) for p, _ in kept]
        gap = judge.widest_gaps(cell.conf, params, harness.sampled_calls(t, kept), "cpu")["served"]
        assert 0.0 <= gap <= tiny.TINY_LIMIT


def test_fp8_control_rounds_each_slice_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0], [1e-3, 2e-3, 3e-3]])
    q = dense._quant_fp8(x, -1)
    assert q[0, 2] == -448.0 and q[1, 2] == pytest.approx(3e-3)
    assert (q - x).abs().max() > 0  # 0.3 has no e4m3 value at that scale
    assert ((q - x).abs() <= x.abs().amax(-1, keepdim=True) / 448 * 16).all()
