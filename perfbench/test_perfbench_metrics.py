"""The yardstick's arithmetic: counts from shapes against hand counts, the
trace reduction on made-up events, and every reader on made-up readings."""

import pytest

from perfbench import counts, devtrace, harness, judge
from perfbench.references import dense
from perfbench.traffic import Traffic

# a dense configuration small enough to count by hand
CONF = {"model_type": "dense", "reference": "dense", "num_hidden_layers": 2,
        "hidden_size": 8, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
        "intermediate_size": 16, "vocab_size": 10, "hidden_act": "swiglu",
        "norm": "layernorm", "tie_word_embeddings": False}
A = dense.attention_shapes(CONF)


def test_layer_params_and_call_flops_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8; gate, up and down 8x16 each
    per_layer = 64 + 32 + 32 + 64 + 3 * 128
    # prompt 3, two tokens: 4 tokens through the layers; attention pairs
    # 3*4/2 = 6 in prefill plus 4 in the one decode step; head at 2 positions
    linear = 2 * per_layer * 2 * 4
    attn = 4 * 4 * 2 * (6 + 4) * 2
    assert dense.call_flops(CONF, 3, 2) == linear + attn + 2 * 8 * 10 * 2
    # a plain (squared-ReLU) MLP has two matrices, not three
    plain = dict(CONF, hidden_act="squared_relu")
    assert dense.call_flops(CONF, 3, 2) - dense.call_flops(plain, 3, 2) == 2 * 128 * 2 * 4
    assert counts.decode_pairs(5, 3) == 6 + 7 + 8


def test_layout_draws_every_matrix_and_holds_the_norms_constant():
    lay = dense.layout(CONF)
    drawn = [path for path, _, init in lay if init == "normal"]
    assert drawn[:2] == [("embed",), ("head",)] and len(drawn) == 2 + 2 * 7
    assert {init for _, _, init in lay} == {"normal", 1.0, 0.0}
    np_conf = dict(CONF, norm="layernorm_np", tie_word_embeddings=True)
    assert all(init == "normal" for _, _, init in dense.layout(np_conf))
    assert ("head",) not in [p for p, _, _ in dense.layout(np_conf)]


def test_a_family_the_module_does_not_model_is_refused():
    with pytest.raises(ValueError, match="moe"):
        judge.reference_module(dict(CONF, model_type="moe"))


def test_kernel_counts_by_hand():
    f, b = counts.flash_launch(A, 3, 5)
    assert f == 4 * 4 * 2 * 15 * 3
    assert b == 3 * 5 * 2 * (2 * 4 + 2 * 2) * 2
    f, b = counts.decode_launch(A, 3, 7)
    assert f == 4 * 4 * 2 * 7 * 3
    assert b == 3 * (2 * 4 * 2 + 2 * 7 * 2 * 2) * 2 + 4 * 3
    assert counts.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_trace_reduction():
    dev = [(0, 10, "k1"), (5, 20, "k2"), (30, 40, "k1"), (100, 110, "k3")]
    host = [(0, 200, "outer"), (21, 29, "aten::mm"), (45, 95, "aten::item"),
            (50, 60, "cudaMemcpyAsync")]
    t = devtrace.reduce(1e-6, dev, host)
    assert t.busy_s == pytest.approx((20 + 10 + 10) * 1e-9)
    assert t.kernels["k1"] == [pytest.approx(20e-9), 2]
    assert t.kernel_seconds("k") == pytest.approx(45e-9) and t.kernel_launches("k1") == 2
    # gap 20..30 (middle 25: in aten::mm), gap 40..100 (middle 70: aten::item)
    assert t.gaps == {"aten::mm": pytest.approx(10e-9), "aten::item": pytest.approx(60e-9)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1" and b["idle_gaps"][0][0] == "aten::item"


def _readings(trace=None, traced=()):
    cell = harness.load_cell(harness.cell_names()[0])
    tr = Traffic(cell.traffic, cell.conf["vocab_size"], 1)
    return harness.Readings(conf=cell.conf, family=judge.reference_module(cell.conf),
                            traffic=tr, setup_s=12.5, window_s=10.0,
                            waves=[(1530, 2.0), (1540, 3.0), (1520, 2.5), (1549, 2.1)],
                            prefill_s=4.0, decode_s=3.1, decode_steps=124,
                            memory_peak_bytes=3 * 2**30, trace=trace,
                            traced_waves=list(traced))


def test_end_to_end_readers():
    r = _readings()
    c = r.traffic.concurrency
    assert harness.load_reader("calls_per_s").read(r) == 4 * c / 10.0
    assert harness.load_reader("call_p95_s").read(r) == 3.0
    assert harness.load_reader("setup_s").read(r) == 12.5
    assert harness.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 95) == 10
    assert harness.percentile(list(range(1, 101)), 95) == 95


def test_per_layer_readers():
    r = _readings()
    assert harness.load_reader("engine.prefill_ms").read(r) == pytest.approx(1000.0)
    assert harness.load_reader("engine.decode_ms_per_step").read(r) == pytest.approx(25.0)
    assert harness.load_reader("device.peak_mem_gib").read(r) == 3.0
    mfu = harness.load_reader("mfu_pct").read(r)
    assert 0 < mfu < 100
    for name in ("flash_attention_roofline", "decode_attention_roofline", "device_idle_pct"):
        assert harness.load_reader(name).read(r) is None  # no trace: nothing to read


def test_roofline_readers_on_a_made_up_trace():
    L, steps = 32, 31
    names = {"void flash_mma_kernel<128>(...)": (0.5, L),
             "void attn::decode_chunk_kernel<bf16, 128, attn::DenseRows<bf16> >(...)":
                 (0.2, L * steps),
             "void attn::decode_combine_kernel<bf16, 128>(...)": (0.1, L * steps)}
    t = devtrace.Trace(window_s=4.0, busy_s=3.0, kernels={k: list(v) for k, v in names.items()})
    r = _readings(t, traced=[1549])
    flash = harness.load_reader("flash_attention_roofline").read(r)
    a = r.family.attention_shapes(r.conf)
    f, b = counts.flash_launch(a, 16, 1549)
    assert flash == pytest.approx(100 * counts.roofline_seconds(f, b) * L / 0.5)
    dec = harness.load_reader("decode_attention_roofline").read(r)
    bound = sum(counts.roofline_seconds(*counts.decode_launch(a, 16, 1549 + j + 1))
                for j in range(steps)) * L
    assert dec == pytest.approx(100 * bound / 0.3)
    assert harness.load_reader("device_idle_pct").read(r) is None  # no untraced wall
    r.untraced_s = 3.75  # the traced 4 s took 3.75 s untraced; busy 3 s
    assert harness.load_reader("device_idle_pct").read(r) == pytest.approx(20.0)
    # a launch count the reader does not expect: the path changed, nothing to read
    r2 = _readings(t, traced=[1549, 1549])
    assert harness.load_reader("flash_attention_roofline").read(r2) is None


def test_trace_stretch_compares_waves_of_one_length():
    window = [(100, 1.0), (100, 3.0), (200, 4.0)]
    assert harness.untraced_seconds(window, [100, 200, 100]) == pytest.approx(8.0)
    assert harness.trace_stretch(window, [(100, 2.2), (200, 4.4)]) == pytest.approx(6.6 / 6.0)
    assert harness.trace_stretch(window, [(300, 1.0)]) is None
    assert harness.untraced_seconds(window, [100, 300]) is None
