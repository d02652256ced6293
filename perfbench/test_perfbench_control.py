"""The output check fails what it must: the fp8 control in the program's
place (read at each position of the program's calls, and served whole
through a run, its greedy tokens returned by ``generate``), and the timed
path broken underneath a run (a decode step that returns its state
unchanged, half of a wave's rows left out, a token altered where it is
produced). The chip's cells read the control at their own size with
``calibrate.py``, which gives the cell's check's verdict on it; this is
the same comparison at a size the CPU holds."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness, judge, tiny, weights
from perfbench.traffic import Traffic

CELLS = harness.cell_names()


def _readings(name, seed):
    from repro_torch.serving.engine import Engine

    cell, cfg = tiny.cell(name)
    params = weights.make(cell.conf, seed, "cpu")
    t = Traffic(cell.traffic, cell.conf["vocab_size"], seed)
    eng = Engine(cfg, params, max_len=t.max_len, device="cpu")
    kept = [(p, eng.generate(p, max_new=t.max_new)) for p in (t.prompts(w) for w in range(4))]
    return judge.widest_gaps(cell.conf, params, harness.sampled_calls(t, kept), "cpu",
                             control=True)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_the_limit(name, seed):
    g = _readings(name, seed)
    assert g["served"] <= tiny.TINY_LIMIT < g["control"]


def _serve(name, seed=2**31 + 5):
    """One run of a window of one wave (``seconds`` 0) of 16 calls, all of
    them checked: the same calls whatever the machine's speed."""
    cell, cfg = tiny.cell(name, concurrency=16)
    return harness.serve(cell, seed, 0.0, False, "cpu", time.perf_counter(), cfg=cfg)


def _stale_decode(monkeypatch):
    """A decode step that computes on a copy of the cache and returns the
    cache as it was."""
    from repro_torch.models import lm

    step = lm.decode_step

    def stale(cfg, params, cache, tokens, ctx=None):
        copy = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
        logits, _ = step(cfg, params, copy, tokens, ctx=ctx)
        return logits, cache

    monkeypatch.setattr(lm, "decode_step", stale)


def _half_batch(monkeypatch):
    """Only the first half of a wave's rows served; the others repeat them."""
    from repro_torch.serving.engine import Engine

    gen = Engine.generate

    def half(self, tokens, *a, **k):
        h = tokens.shape[0] // 2
        out = gen(self, tokens[:h], *a, **k)
        return np.concatenate([out, out[: tokens.shape[0] - h]])

    monkeypatch.setattr(Engine, "generate", half)


def _altered_token(monkeypatch):
    """The third token of every call replaced where it is sampled."""
    from repro_torch.serving import engine

    sample = engine.sample_token
    n = {"i": 0}

    def altered(logits, *a, **k):
        tok = sample(logits, *a, **k)
        n["i"] += 1
        return (tok + 1) % logits.shape[-1] if n["i"] % 16 == 3 else tok

    monkeypatch.setattr(engine, "sample_token", altered)


def _fp8_in_the_programs_place(monkeypatch, name, seed):
    """``Engine.generate`` replaced by greedy decoding with the fp8 control:
    the plain reference in fp8, on the weights drawn from the run's seed."""
    from repro_torch.serving.engine import Engine

    conf = tiny.cell(name)[0].conf
    ref = judge.reference_module(conf)
    params = weights.make(conf, seed, "cpu")

    def fp8_generate(self, tokens, max_new=32, **kw):
        seqs = [torch.as_tensor(row, dtype=torch.int64) for row in tokens]
        out = []
        for _ in range(max_new):
            low = ref.logits(conf, params, seqs, [[len(q) - 1] for q in seqs], precision="fp8")
            nxt = [int(lo[0].argmax()) for lo in low]
            out.append(nxt)
            seqs = [torch.cat([q, torch.tensor([t])]) for q, t in zip(seqs, nxt)]
        return np.array(out, dtype=np.int64).T

    monkeypatch.setattr(Engine, "generate", fp8_generate)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_served_is_not_correct(name, seed, monkeypatch):
    _fp8_in_the_programs_place(monkeypatch, name, seed)
    res = _serve(name, seed)
    assert res["failed"] == 0  # well formed: only the comparison with the reference fails it
    assert not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > tiny.TINY_LIMIT


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _serve(name)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_stale_decode, _half_batch, _altered_token],
                         ids=["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _serve(name)
    assert not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > tiny.TINY_LIMIT
