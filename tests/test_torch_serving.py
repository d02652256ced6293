"""The port's serving engine (``repro_torch.serving``) on the CPU: the
engine tests of tests/test_serving.py run against it, greedy generation is
token-identical to ``repro.serving.engine.Engine`` on the same weights,
and the engine refuses to run on the CPU unless asked to."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.apc_minion import DEFAULT  # noqa: E402
from repro_torch.launch.serve import arch_seed, build_engines  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.sampler import sample_token  # noqa: E402

torch.set_num_threads(2)


def _engine(arch, max_len=48, seed=0):
    cfg = registry.get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return Engine(cfg, params, max_len=max_len, device="cpu")


def test_engine_generate_and_rates():
    eng = _engine("olmo-1b")
    toks = np.random.RandomState(0).randint(3, 400, (3, 12)).astype(np.int32)
    out = eng.generate(toks, max_new=6)
    assert out.shape == (3, 6)
    r = eng.measured_rates()
    assert r["prefill"] > 0 and r["decode"] > 0


def test_engine_greedy_deterministic():
    eng = _engine("qwen2.5-3b")
    toks = np.random.RandomState(1).randint(3, 400, (2, 10)).astype(np.int32)
    a = eng.generate(toks, max_new=5)
    b = eng.generate(toks, max_new=5)
    np.testing.assert_array_equal(a, b)


def test_engine_pads_after_eos_and_counts_active_rows():
    """Rows past their EOS must emit pad_id, not freshly sampled garbage,
    and must stop counting toward decode throughput."""
    eng = _engine("olmo-1b")
    toks = np.random.RandomState(0).randint(3, 400, (3, 12)).astype(np.int32)
    probe = eng.generate(toks, max_new=2)
    eos = int(probe[0, 1])
    d0 = eng.stats.decode_tokens
    out = eng.generate(toks, max_new=6, eos_id=eos, pad_id=1)
    for r in range(out.shape[0]):
        hits = np.where(out[r] == eos)[0]
        if hits.size:
            assert (out[r, hits[0] + 1:] == 1).all(), f"row {r} post-EOS garbage"
    steps = out.shape[1] - 1
    finished_early = any(
        np.where(out[r] == eos)[0].size and np.where(out[r] == eos)[0][0] < steps
        for r in range(out.shape[0])
    )
    assert finished_early  # row 0 stops at step 1 by construction
    assert eng.stats.decode_tokens - d0 < out.shape[0] * steps


def test_engine_generate_rejects_over_capacity():
    """prompt + max_new beyond max_len fails up front; exact capacity is fine."""
    eng = _engine("olmo-1b", max_len=32)
    toks = np.random.RandomState(0).randint(3, 400, (2, 12)).astype(np.int32)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(toks, max_new=21)
    out = eng.generate(toks, max_new=20)
    assert out.shape == (2, 20)


def test_engine_prefill_counts_only_valid_tokens():
    eng = _engine("olmo-1b")
    toks = np.random.RandomState(0).randint(3, 400, (2, 16)).astype(np.int32)
    toks[0, 10:] = 0  # right-padded row: 10 valid
    eng.prefill(toks, n_valid=26)
    assert eng.stats.prefill_tokens == 26


def _traced(fn):
    """``fn()`` under a tracer: (its result, the finished spans)."""
    from repro_torch.obs import InMemoryExporter, Tracer, use_tracer

    mem = InMemoryExporter()
    with use_tracer(Tracer(exporters=[mem])):
        out = fn()
    return out, mem.spans


def test_traced_generate_spans_the_prefill_and_each_decode_step():
    """One ``engine.generate`` holds one ``engine.prefill`` and a
    ``engine.decode_step`` a decode step (max_new - 1 of them), with their
    attributes, in order and inside their parent; the tokens are those of
    an untraced call, and the host's share of the decode time is counted."""
    eng = _engine("olmo-1b")
    toks = np.random.RandomState(0).randint(3, 400, (3, 12)).astype(np.int32)
    plain = eng.generate(toks, max_new=6)
    s0 = dataclasses.replace(eng.stats)
    out, spans = _traced(lambda: eng.generate(toks, max_new=6))
    np.testing.assert_array_equal(out, plain)
    (gen,) = [s for s in spans if s["name"] == "engine.generate"]
    kids = sorted((s for s in spans if s["parent_id"] == gen["span_id"]),
                  key=lambda s: s["start"])
    assert len(spans) == 1 + len(kids) == 1 + 1 + 5
    assert kids[0]["name"] == "engine.prefill"
    assert kids[0]["attrs"] == {"batch": 3, "tokens": 12, "prefix": "none"}
    assert [s["name"] for s in kids[1:]] == ["engine.decode_step"] * 5
    # the CPU engine decodes eagerly: a CUDA graph is the card's alone
    assert [s["attrs"] for s in kids[1:]] == [{"step": i, "active": 3, "graph": "eager"}
                                             for i in range(5)]
    for a, b in zip(kids, kids[1:]):
        assert a["end"] <= b["start"]
    assert gen["start"] <= kids[0]["start"] and kids[-1]["end"] <= gen["end"]
    host = eng.stats.decode_host_s - s0.decode_host_s
    assert 0 < host <= eng.stats.decode_s - s0.decode_s


def test_traced_generate_tells_a_prefix_miss_from_a_hit():
    """Through a cache point the prefill span says ``miss`` (a full prefill
    that registers the template), then ``hit`` (the suffix alone)."""
    from repro_torch.serving import kv_cache as tkv

    cfg = registry.get_smoke("olmo-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pool = tkv.pool_for_config(cfg, num_pages=32, page_size=8, device="cpu")
    eng = Engine(cfg, params, max_len=48, device="cpu", kv_prefix=tkv.KVPrefixCache(pool))
    rs = np.random.RandomState(1)
    tpl = rs.randint(3, 400, (16,)).astype(np.int32)
    toks = np.concatenate([np.broadcast_to(tpl, (2, 16)),
                           rs.randint(3, 400, (2, 6)).astype(np.int32)], axis=1)
    cp = tkv.plan_cache_point("tpl", tpl, toks)
    seen = []
    for _ in range(2):
        out, spans = _traced(lambda: eng.generate(toks, max_new=3, cache_point=cp))
        (pre,) = [s for s in spans if s["name"] == "engine.prefill"]
        seen.append(pre["attrs"])
        assert sum(s["name"] == "engine.decode_step" for s in spans) == 2
    assert seen == [{"batch": 2, "tokens": 22, "prefix": p} for p in ("miss", "hit")]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b", "nemotron-4-15b", "rwkv6-3b",
                                  "zamba2-2.7b", "granite-moe-1b-a400m", "qwen3-4b",
                                  "qwen2-vl-7b", "kimi-k2-1t-a32b"])
def test_greedy_generate_token_identical_to_reference(arch):
    """f32, same weights (carried from the reference's init), same prompts:
    the port's greedy tokens equal the reference engine's."""
    kw = dict(vocab_size=50_304, dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jregistry.get_smoke(arch), **kw)
    tcfg = dataclasses.replace(registry.get_smoke(arch), **kw)
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    pt = lm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    toks = np.random.RandomState(7).randint(3, 50_000, (2, 13)).astype(np.int32)
    want = JEngine(jcfg, pj, max_len=40).generate(toks, max_new=10)
    got = Engine(tcfg, pt, max_len=40, device="cpu").generate(toks, max_new=10)
    np.testing.assert_array_equal(got, want)


def test_engine_requires_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = registry.get_smoke("olmo-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engines(DEFAULT)


def test_build_engines_shares_archs_and_seeds_stably():
    """Roles on one arch share an engine; weights come from a seed that is
    stable across processes (crc32 of the arch name, not hash())."""
    a = build_engines(DEFAULT, device="cpu")
    assert a["small_planner"] is a["keyword_extractor"]
    assert len({id(e) for e in a.values()}) == 3
    assert arch_seed("olmo-1b") == 0xc837aa8f
    b = build_engines(DEFAULT, device="cpu")
    for role in a:
        assert a[role].cfg.vocab_size == 50_304  # the tokenizer's ids all fit
        assert torch.equal(a[role].params["embed"], b[role].params["embed"])


def test_sampler_greedy_and_top_k():
    logits = torch.tensor([[0.1, 3.0, 3.0, -1.0], [5.0, 0.0, 0.0, 4.9]])
    np.testing.assert_array_equal(sample_token(logits).numpy(), [[1], [0]])  # first max
    assert sample_token(logits).dtype == torch.int32
    g = torch.Generator().manual_seed(0)
    draws = torch.cat([sample_token(logits, 1.0, g, top_k=2) for _ in range(200)], dim=1)
    assert set(draws[0].tolist()) == {1, 2} and set(draws[1].tolist()) == {0, 3}


def test_engine_config_widens_narrow_vocabularies_only():
    """Every smoke config, and zamba2-2.7b's published 32,000, widen to the
    tokenizer's 50,304; the published configs with wider vocabularies keep
    theirs, and nothing else changes."""
    from repro_torch.launch.serve import engine_config

    for arch in registry.ARCH_NAMES:
        smoke = engine_config(arch)
        assert smoke == dataclasses.replace(registry.get_smoke(arch), vocab_size=50_304)
        full = engine_config(arch, full=True)
        assert full == dataclasses.replace(registry.get(arch),
                                           vocab_size=max(50_304, registry.get(arch).vocab_size))
    assert engine_config("zamba2-2.7b", full=True).vocab_size == 50_304
    assert engine_config("rwkv6-3b", full=True).vocab_size == 65_536
    # granite's published 49,155 widens too; it ties its embeddings, so the
    # widened table is also its head
    granite = engine_config("granite-moe-1b-a400m", full=True)
    assert granite.vocab_size == 50_304 and granite.tie_embeddings
    assert engine_config("kimi-k2-1t-a32b", full=True).vocab_size == 163_840


def test_engine_refuses_the_audio_family():
    """An Engine serves token prompts; whisper also needs the frontend's
    frames, so an audio Engine raises and names lm.prefill instead."""
    cfg = registry.get_smoke("whisper-tiny")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="frames"):
        Engine(cfg, params, max_len=32, device="cpu")


def test_build_engines_takes_the_recurrent_archs():
    """A deployment with rwkv6-3b and zamba2-2.7b roles builds their smoke
    engines (vocab widened to the tokenizer's), shares an arch between
    roles, keeps them off the page pool, and generates from a state cache."""
    from repro_torch.configs.apc_minion import APCDeployment

    dep = APCDeployment(small_planner="rwkv6-3b", keyword_extractor="rwkv6-3b",
                        actor="zamba2-2.7b")
    eng = build_engines(dep, device="cpu")
    assert eng["small_planner"] is eng["keyword_extractor"]
    assert {e.cfg.family for e in eng.values()} == {"dense", "ssm", "hybrid"}
    toks = np.random.RandomState(2).randint(3, 50_000, (1, 11)).astype(np.int32)
    for role in ("small_planner", "actor"):
        e = eng[role]
        assert e.cfg.vocab_size == 50_304 and e.kv_prefix is None
        out = e.generate(toks, max_new=4)
        assert out.shape == (1, 4) and e.stats.decode_tokens == 3


def test_serve_entry_point_runs_other_workloads_and_methods(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --env aime --method cascade --n 4
    --device cpu`` on the smoke configs prints the accuracy and hit rate the
    reference harness gives on the same tasks; ``--env`` and ``--method``
    take every workload and every registered method."""
    import sys

    from repro.core.harness import run_workload as jrun_workload
    from repro_torch.core.methods import method_names
    from repro_torch.envs.workloads import ALL_ENVS
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--env", "aime", "--method", "cascade",
                                      "--n", "4", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    want = jrun_workload("aime", "cascade", 4)
    assert want.hit_rate > 0
    assert f"accuracy      {want.accuracy:.3f}" in out
    assert f"hit rate      {want.hit_rate:.3f}" in out
    assert f"cost          ${want.cost:.4f}" in out
    assert "method=cascade n=4 device=cpu" in out
    for flag, value in (("--env", "webshop"), ("--method", "no_such_method")):
        monkeypatch.setattr(sys, "argv", ["serve", flag, value, "--device", "cpu"])
        with pytest.raises(SystemExit):
            serve.main()
        assert "invalid choice" in capsys.readouterr().err
    assert ALL_ENVS == ["financebench", "tabmwp", "qasper", "aime", "gaia"]
    assert {"apc", "accuracy_optimal", "cost_optimal", "semantic", "full_history",
            "cascade", "speculative"} == set(method_names())
