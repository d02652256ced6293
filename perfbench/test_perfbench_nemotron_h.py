"""The nemotron_h family's part of the benchmark: its plain reference
(``references/nemotron_h.py``) against the port at the tiny size, the
faults of the Mamba-2 scan that the cell's check must fail, the counts the
new readers use, by hand, and the configuration file against the port's."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from perfbench import counts, devtrace, harness, tiny, weights
from perfbench.references import nemotron_h as nh
from perfbench.traffic import Traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "nemotron-h-47b.plan_miss"


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp32(v) for v in tree]
    return tree.float()


def test_reference_logits_equal_the_ports_in_float32():
    from repro_torch.models import lm

    cell, cfg = tiny.cell(CELL)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = _fp32(weights.make(cell.conf, 5, "cpu"))
    toks = torch.randint(0, cell.conf["vocab_size"], (2, 37),
                         generator=torch.Generator().manual_seed(1))
    ours, _, _ = lm.forward(cfg, params, toks)
    ref = nh.logits(cell.conf, params, list(toks), [range(37)] * 2)
    for b in range(2):
        torch.testing.assert_close(ref[b], ours[b].float(), rtol=1e-4, atol=1e-4)


def _serve(seed=2**31 + 5):
    """One run of a window of one wave of 16 calls, all of them checked."""
    cell, cfg = tiny.cell(CELL, concurrency=16)
    return harness.serve(cell, seed, 0.0, False, "cpu", time.perf_counter(), cfg=cfg)


def _groups_permuted(monkeypatch):
    """Each head reads the next group's B and C, in prefill and decode."""
    from repro_torch.models import mamba

    split = mamba._scan_bc
    monkeypatch.setattr(mamba, "_scan_bc",
                        lambda cfg, co: tuple(t.roll(1, dims=-2) for t in split(cfg, co)))


def _state_zeroed_every_chunk(monkeypatch, chunk=16):
    """The prefill's scan restarts from a zero state every ``chunk`` steps
    (the cut cell's prompts are 45-52 tokens, so every prompt crosses
    chunks)."""
    from repro_torch.kernels import ops

    scan = ops.ssd_op

    def restarting(x, dt, A_log, B_, C_, D, **kw):
        ys, st = [], None
        for c0 in range(0, x.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            y, st = scan(x[:, sl], dt[:, sl], A_log, B_[:, sl], C_[:, sl], D, **kw)
            ys.append(y)
        return torch.cat(ys, dim=1), st

    monkeypatch.setattr(ops, "ssd_op", restarting)


def _stale_decode_state(monkeypatch):
    """Each decode step leaves the SSM state as the prefill left it (the
    conv carry and the K/V still advance)."""
    from repro_torch.models import mamba

    step = mamba.mamba_step

    def stale(cfg, p, x, state, conv_prev, **kw):
        y, _, carry = step(cfg, p, x, state, conv_prev, **kw)
        return y, state, carry

    monkeypatch.setattr(mamba, "mamba_step", stale)


def test_a_sound_tiny_run_is_within_the_limit():
    res = _serve()
    assert res["correct"] and res["checks"]["max_logit_gap"]["value"] <= tiny.TINY_LIMIT


@pytest.mark.parametrize("fault", [_groups_permuted, _state_zeroed_every_chunk,
                                   _stale_decode_state],
                         ids=["groups_permuted", "state_zeroed_every_chunk", "stale_decode_state"])
def test_a_broken_scan_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _serve()
    assert res["failed"] == 0 and not res["correct"]
    assert res["checks"]["max_logit_gap"]["value"] > tiny.TINY_LIMIT


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path[:0] = ['.']\n"
            "import perfbench.references.nemotron_h, perfbench.judge\n"
            "print(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    tops = {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


# a configuration small enough to count by hand: d 8, Mamba-2 d_in 16 in 2
# heads of 8 and 2 groups of state 4 (conv channels 16 + 16 = 32), d_ff 16,
# attention 4 heads of 2 over 2 kv heads, vocabulary 10
CONF = {"model_type": "nemotron_h", "reference": "nemotron_h", "hidden_size": 8,
        "num_hidden_layers": 3, "hybrid_override_pattern": "M*-M", "intermediate_size": 16,
        "num_attention_heads": 4, "num_key_value_heads": 2, "attention_head_dim": 2,
        "vocab_size": 10, "tie_word_embeddings": False, "expand": 2, "mamba_head_dim": 8,
        "n_groups": 2, "ssm_state_size": 4, "conv_kernel": 4, "chunk_size": 128,
        "mlp_hidden_act": "relu2", "mamba_hidden_act": "silu", "dtype": "bfloat16",
        "mamba_conv_w": 0.25, "mamba_A_log": 0.0, "mamba_dt_bias": -2.0, "mamba_D": 0.0}


def test_layout_by_hand():
    lay = nh.layout(CONF)
    drawn = {path: shape for path, shape, init in lay if init == "normal"}
    # in_proj: z 16, x 16, B 8, C 8, dt 2
    assert drawn == {("embed",): (10, 8), ("head",): (8, 10),
                     ("blocks", 0, "mamba", "in_proj"): (8, 50),
                     ("blocks", 0, "mamba", "out_proj"): (16, 8),
                     ("blocks", 1, "attn", "wq"): (8, 8), ("blocks", 1, "attn", "wk"): (8, 4),
                     ("blocks", 1, "attn", "wv"): (8, 4), ("blocks", 1, "attn", "wo"): (8, 8),
                     ("blocks", 2, "mlp", "w_up"): (8, 16), ("blocks", 2, "mlp", "w_down"): (16, 8)}
    held = {path: (shape, init) for path, shape, init in lay if init != "normal"}
    assert held[("blocks", 0, "mamba", "conv_w")] == ((4, 32), 0.25)
    assert held[("blocks", 0, "mamba", "D")] == ((2,), 0.0)
    assert held[("blocks", 0, "mamba", "dt_bias")] == ((2,), -2.0)
    assert held[("blocks", 0, "mamba", "norm_scale")] == ((16,), 1.0)
    assert {p for p in held if p[-1] == "ln1_scale"} == {("blocks", i, "ln1_scale")
                                                        for i in range(3)}
    assert nh.mamba_layers(CONF) == 1 and nh.attention_shapes(CONF).layers == 1


def test_call_and_scan_counts_by_hand():
    # matrices a token: in_proj 400 + out_proj 128, attention 64 + 32 + 32 + 64,
    # MLP 256 = 976; prompt 3 and 2 new tokens: 4 tokens through the layers
    linear = 2 * 976 * 4
    conv = 2 * 4 * 32 * 4  # taps x channels, a token
    scan = 4 * 2 * 8 * 4 * 4  # 4 P N a head and token
    attn = 4 * 4 * 2 * (6 + 4)  # causal pairs 3*4/2 in prefill, 4 in the decode step
    head = 2 * 8 * 10 * 2
    assert nh.call_flops(CONF, 3, 2) == linear + conv + scan + attn + head
    f, b = nh.ssd_launch(CONF, 3, 5)
    assert f == 4 * 2 * 8 * 4 * 15
    # x (2 heads x 8) and B, C (2 groups x 4 each) in bf16, dt f32, A_log and
    # D f32; y bf16 and the final state (3 rows x 2 heads x 8 x 4) f32
    assert b == 15 * (16 + 16) * 2 + 15 * 2 * 4 + 2 * 2 * 4 + 15 * 16 * 2 + 3 * 2 * 8 * 4 * 4


def test_the_files_mamba_keys_are_the_ports():
    conf = harness.load_cell(CELL).conf
    cfg = harness.model_config(conf)
    s = cfg.ssm
    assert (conf["ssm_state_size"], conf["mamba_head_dim"], conf["expand"], conf["conv_kernel"],
            conf["chunk_size"], conf["n_groups"]) == (
        s.state_dim, s.head_dim, s.expand, s.conv_dim, s.chunk_size, s.n_groups)
    d_in, heads, _, _, _, _ = nh.mamba_dims(conf)
    assert heads == conf["mamba_num_heads"] == 256 and d_in == s.expand * cfg.d_model
    assert (conf["mlp_hidden_act"], cfg.mlp_act) == ("relu2", "squared_relu")
    assert (cfg.norm_type, cfg.rope_type, conf["rms_norm_eps"]) == ("rmsnorm", "none", cfg.norm_eps)
    assert not (conf["attention_bias"] or conf["mlp_bias"] or conf["mamba_proj_bias"])
    assert conf["use_conv_bias"] and conf["time_step_limit"] == [0, None]
    assert conf["reduced"] == ["num_hidden_layers"] and conf["num_hidden_layers"] == 49
    assert len(conf["hybrid_override_pattern"]) == 98


def _readings(trace, traced, waves):
    cell = harness.load_cell(CELL)
    tr = Traffic(cell.traffic, cell.conf["vocab_size"], 1)
    return harness.Readings(conf=cell.conf, family=nh, traffic=tr, setup_s=30.0,
                            window_s=50.0, waves=waves, prefill_s=30.0, decode_s=18.0,
                            decode_steps=31 * len(waves), memory_peak_bytes=60 * 2**30,
                            trace=trace, traced_waves=list(traced))


def test_the_new_readers_on_made_up_readings():
    L = 24  # Mamba-2 layers of the cut
    kernel = "void (anonymous namespace)::ssd_kernel<__nv_bfloat16, 64, 256>(...)"
    t = devtrace.Trace(window_s=5.0, busy_s=4.5, kernels={kernel: [0.3, L]})
    waves = [(1530, 4.0), (1540, 5.0)]
    r = _readings(t, [1549], waves)
    bound = counts.roofline_seconds(*nh.ssd_launch(r.conf, 16, 1549)) * L
    assert harness.load_reader("ssd_scan_roofline").read(r) == pytest.approx(100 * bound / 0.3)
    assert 0 < harness.load_reader("ssd_scan_roofline").read(r) < 100
    # a launch count the reader does not expect, or no trace: nothing to read
    assert harness.load_reader("ssd_scan_roofline").read(_readings(t, [1549] * 2, waves)) is None
    assert harness.load_reader("ssd_scan_roofline").read(_readings(None, [], waves)) is None
    mfu = harness.load_reader("mfu_pct").read(r)
    want = sum(16 * nh.call_flops(r.conf, s, 32) for s, _ in waves) / (50.0 * 989e12)
    assert mfu == pytest.approx(100 * want) and 0 < mfu < 100


def test_every_metric_listed_for_the_cell_reads_the_hybrid():
    """Each per-layer metric whose ``workloads`` name the cell finds its
    numbers in a made-up traced run of it: the 2 attention layers' flash
    launch a traced wave and decode launches a step, the 24 scans."""
    kernels = {"flash_fwd_kernel<bf16, 128>": [0.01, 2],
               "decode_chunk_kernel<DenseRows, 128>": [0.02, 2 * 31],
               "decode_combine_kernel<128>": [0.001, 2 * 31],
               "ssd_kernel<__nv_bfloat16, 64, 256>": [0.3, 24]}
    t = devtrace.Trace(window_s=5.0, busy_s=4.5, kernels=kernels)
    r = _readings(t, [1549], [(1530, 4.0), (1540, 5.0)])
    r.untraced_s = 4.6
    cell = harness.load_cell(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert "mfu_pct" in names and "ssd_scan_roofline" in names and len(names) == 8
    for name in names:
        v = harness.load_reader(name).read(r)
        assert v is not None and v > 0, name
