"""The port's deterministic simulation (``repro_torch.sim``) against
``repro.sim`` on the CPU: a twin of each case of tests/test_sim.py (the
store-level seam cases are in tests/test_torch_distributed_cache.py, in
lockstep with the reference's store; the cold-tier cases in
tests/test_torch_sim_cold.py), where a case runs whole simulations the
port's report held to the reference's on the same config; the seed-0
``--check`` matrix through both packages; replay files crossing between the
packages; the CLI; and ``chip_smoke.py``'s phase-10 pins."""

import dataclasses
import os
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import sim as jsim  # noqa: E402
from repro.envs import workloads as jwl  # noqa: E402
from repro.sim.__main__ import main as jmain  # noqa: E402
from repro_torch.core.distributed_cache import DistributedPlanCache  # noqa: E402
from repro_torch.envs.workloads import SIM_SCENARIOS, sim_traffic  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    ABLATION_OF,
    ALL_ABLATIONS,
    EXTRA_PLAN_ABLATIONS,
    FAULT_PLANS,
    SCENARIO_ABLATION_OF,
    ModelStore,
    SimConfig,
    StepScheduler,
    TraceRecorder,
    VirtualClock,
    make_value,
    run_sim,
    value_torn,
)
from repro_torch.sim.__main__ import PINNED_SCENARIO, matrix_cells  # noqa: E402
from repro_torch.sim.__main__ import main as tmain  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

# the cells whose runs reach the cold tier (tests/test_torch_sim_cold.py)
COLD_CELLS = ("s0-evict_then_hit-cold_tier", "s0-ablate-cold_gc_refcount")
REPORT_FIELDS = ("trace_hash", "span_digest", "steps", "ops_applied", "lookups", "inserts",
                 "store_stats", "router_metrics", "interceptor", "cachegen", "n_spans",
                 "span_summary", "cold_stats", "speculation")

# tests/test_sim.py's EXPECTED_ORACLES: the oracles each plan's ablated guard
# may trip
EXPECTED_ORACLES = {
    "crash_restart": {"durability"},
    "replica_lag": {"linearizability", "durability", "control_plane"},
    "hedge_timeout": {"completeness"},
    "mid_wave_evict": {"eviction_order", "durability", "phantom"},
    "membership_churn": {"durability", "linearizability", "control_plane"},
    "async_cachegen": {"cachegen_loss"},
    "cold_tier": {"durability"},
    "ttl_churn": {"phantom", "control_plane"},
    "speculative_exec": {"spec_leak"},
}


def _cfg(**kw):
    kw.setdefault("n_ops", 30)
    return SimConfig(**kw)


def _ref_cfg(cfg):
    return jsim.SimConfig(**dataclasses.asdict(cfg))


def assert_same_report(port, ref):
    """Everything a run reports, bit for bit: config, trace hash, span
    digest, violations, every counter."""
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    for f in REPORT_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert ([dataclasses.asdict(v) for v in port.violations]
            == [dataclasses.asdict(v) for v in ref.violations])
    assert port.trace_tail == ref.trace_tail


def run_both(cfg):
    port = run_sim(cfg, device="cpu")
    assert_same_report(port, jsim.run_sim(_ref_cfg(cfg)))
    return port


# -- the seed-0 --check matrix through both packages ---------------------------

CLEAN0, AUDIT0 = matrix_cells(0)


def test_matrix_cells_are_the_reference_check_cells():
    """``matrix_cells`` lists the cells ``python -m repro.sim --check`` runs
    at a seed, in its order (its loop, rebuilt from the reference's
    constants)."""
    assert PINNED_SCENARIO == {"mid_wave_evict": "evict_then_hit", "cold_tier": "evict_then_hit",
                               "ttl_churn": "skewed_reuse",
                               "speculative_exec": "paraphrase_burst"}
    jf = jsim.faults
    want = [SimConfig(seed=0, scenario=s, fault=f)
            for s in jwl.SIM_SCENARIOS for f in jf.FAULT_PLANS
            if f not in PINNED_SCENARIO or s == PINNED_SCENARIO[f]]
    assert [cfg for _, cfg in CLEAN0] == want
    audit = ([SimConfig(seed=0, fault=f, ablate=(g,)) for f, g in sorted(jf.ABLATION_OF.items())]
             + [SimConfig(seed=0, scenario=s, replication=1, ablate=(g,))
                for s, g in sorted(jf.SCENARIO_ABLATION_OF.items())]
             + [SimConfig(seed=0, fault=f, ablate=(g,))
                for f, g in sorted(jf.EXTRA_PLAN_ABLATIONS.items())])
    assert [cfg for _, cfg in AUDIT0] == audit
    assert len(CLEAN0) + len(AUDIT0) == 39  # "sim-check: 39 cells" a seed


@pytest.mark.parametrize("tag", [t for t, _ in CLEAN0 + AUDIT0 if t not in COLD_CELLS])
def test_check_matrix_cell_matches_reference(tag):
    """Each seed-0 cell of the matrix: the port's report equals the
    reference's (trace hash, span digest, violations, store stats, router
    metrics, ...); a clean cell shows no violation, an audit cell trips its
    guard's oracle; a non-fuzzy cell's hash is chip_smoke's pin."""
    cfg = dict(CLEAN0 + AUDIT0)[tag]
    r = run_both(cfg)
    if cfg.ablate:
        assert {v.oracle for v in r.violations} & chip_smoke.SIM_ORACLES[cfg.ablate[0]]
    else:
        assert r.ok, r.violations[:3]
    if not cfg.normalized().fuzzy:
        assert chip_smoke.SIM_REF_HASHES[tag[len("s0-"):]] == r.trace_hash


def test_chip_smoke_sim_constants():
    """Phase 10's pins cover exactly the seed-0 non-fuzzy cells, its oracle
    table every guard, and its soak is a fuzzy cell."""
    nonfuzzy = {t[len("s0-"):] for t, cfg in CLEAN0 + AUDIT0 if not cfg.normalized().fuzzy}
    assert set(chip_smoke.SIM_REF_HASHES) == nonfuzzy
    assert set(chip_smoke.SIM_ORACLES) == set(ALL_ABLATIONS)
    for fault, guard in ABLATION_OF.items():
        assert chip_smoke.SIM_ORACLES[guard] == EXPECTED_ORACLES[fault]
    assert SimConfig(**chip_smoke.SIM_SOAK).normalized().fuzzy


def test_device_backend_on_the_cpu_hashes_as_auto():
    """Phase 10's CPU side: a fuzzy cell on the ``device`` backend (the
    plain top-k on the CPU) gives the trace of the ``auto`` backend, which
    is the reference's, and stays deterministic."""
    cfg = SimConfig(seed=1, scenario="paraphrase_burst", fault="crash_restart", n_ops=20)
    a = run_sim(cfg, device="cpu", index_backend="device")
    b = run_sim(cfg, device="cpu", index_backend="device")
    assert a.ok and a.index_backend == "device" and a.device == "cpu"
    assert (a.trace_hash, a.span_digest) == (b.trace_hash, b.span_digest)
    assert a.trace_hash == jsim.run_sim(_ref_cfg(cfg)).trace_hash
    assert run_sim(cfg, device="cpu").index_backend == "auto"


# -- determinism ---------------------------------------------------------------


def test_same_seed_identical_trace():
    a = run_both(_cfg(seed=11))
    b = run_sim(_cfg(seed=11), device="cpu")
    assert a.ok and b.ok
    assert a.trace_hash == b.trace_hash
    assert a.steps == b.steps and a.ops_applied == b.ops_applied


def test_different_seeds_diverge():
    a = run_sim(_cfg(seed=1), device="cpu")
    b = run_sim(_cfg(seed=2), device="cpu")
    assert a.trace_hash != b.trace_hash


@pytest.mark.parametrize("scenario", SIM_SCENARIOS)
def test_every_scenario_clean_and_deterministic(scenario):
    cfg = _cfg(seed=5, scenario=scenario)
    a = run_both(cfg)
    assert a.ok, a.violations[:3]
    assert run_sim(cfg, device="cpu").trace_hash == a.trace_hash


def test_sim_traffic_seeded_and_scenario_shaped():
    t1 = sim_traffic("skewed_reuse", 9, n_ops=20, n_clients=3)
    t2 = sim_traffic("skewed_reuse", 9, n_ops=20, n_clients=3)
    assert t1 == t2
    assert len(t1) == 3 and all(len(ops) == 20 for ops in t1)
    assert t1 != sim_traffic("skewed_reuse", 10, n_ops=20, n_clients=3)
    assert t1 == jwl.sim_traffic("skewed_reuse", 9, n_ops=20, n_clients=3)
    with pytest.raises(ValueError):
        sim_traffic("nope", 0)


# -- fault plans under guards --------------------------------------------------


@pytest.mark.parametrize("fault", [f for f in FAULT_PLANS if f not in ("none", "cold_tier")])
def test_fault_plans_clean_under_guards(fault):
    r = run_both(_cfg(seed=3, fault=fault))
    assert r.ok, r.violations[:3]
    if fault in ("crash_restart", "replica_lag", "membership_churn"):
        assert r.interceptor["failed_calls"] > 0
    if fault == "hedge_timeout":
        assert r.router_metrics is not None and r.router_metrics["requests"] > 0
    if fault == "async_cachegen":
        assert r.cachegen["submitted"] > 0 and r.cachegen["rejected"] > 0
        assert r.router_metrics["async_cachegens"] > 0
        assert r.router_metrics["sync_cachegen_fallbacks"] > 0
        assert r.router_metrics["cachegen_dropped"] == 0
    if fault == "ttl_churn":
        assert r.store_stats["misses"] > 0
    if fault == "speculative_exec":
        s = r.speculation
        assert s is not None and s["begun"] > 0
        assert s["pending"] == 0 and s["forced_commits"] == 0
        assert s["commits"] == s["verifier_agreed"]
        assert s["begun"] == s["commits"] + s["rollbacks"]
        assert s["ws_compensations"] == s["rollbacks"]
        assert s["ws_keys"] == s["commits"]
        assert r.router_metrics["spec_sync_verifies"] > 0
        assert r.router_metrics["spec_dropped"] == 0


def test_replica_lag_guard_blocks_stale_reads():
    r = run_sim(_cfg(seed=3, fault="replica_lag"), device="cpu")
    assert r.ok
    assert r.interceptor["deferred_writes"] == 0
    ablated = run_both(_cfg(seed=3, fault="replica_lag", ablate=("replica_ack",)))
    assert ablated.interceptor["deferred_writes"] > 0


# -- oracle teeth: every guard ablation must be caught -------------------------


@pytest.mark.parametrize("fault,guard", sorted(g for g in ABLATION_OF.items()
                                               if g[0] != "cold_tier"))
def test_guard_ablation_is_caught_by_matching_oracle(fault, guard):
    r = run_both(_cfg(seed=3, fault=fault, ablate=(guard,)))
    assert r.violations, f"{fault} with {guard} ablated produced no violations"
    assert {v.oracle for v in r.violations} & EXPECTED_ORACLES[fault]


@pytest.mark.parametrize("scenario,guard", sorted(SCENARIO_ABLATION_OF.items()))
def test_scenario_guard_ablation_is_caught(scenario, guard):
    r = run_both(_cfg(seed=3, scenario=scenario, replication=1, ablate=(guard,)))
    assert r.violations, f"{scenario} with {guard} ablated stayed green"
    assert {v.oracle for v in r.violations} & {"durability"}


def test_unknown_ablation_and_plan_raise_as_the_reference():
    for bad in (dict(ablate=("nope",)), dict(fault="nope"), dict(scenario="nope")):
        with pytest.raises(ValueError) as port:
            run_sim(_cfg(**bad), device="cpu")
        with pytest.raises(ValueError) as ref:
            jsim.run_sim(jsim.SimConfig(n_ops=30, **bad))
        assert str(port.value) == str(ref.value)


# -- replayable failure seeds --------------------------------------------------


def test_failing_seed_dumps_and_replays_identically(tmp_path, capsys):
    rc = tmain(["--seed", "3", "--fault", "crash_restart", "--ablate", "crash_fallthrough",
                "--ops", "30", "--dump-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 1
    dumps = list(tmp_path.glob("sim-repro-*.json"))
    assert len(dumps) == 1
    rc = tmain(["--replay", str(dumps[0]), "--dump-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "replay reproduced the recorded interleaving exactly" in out
    assert "VIOLATION" in out


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_dumps_replay_across_packages(direction, tmp_path, capsys):
    """A repro file dumped by either package replays in the other to the
    recorded hash (the port's records its device beside the config)."""
    args = ["--seed", "3", "--fault", "async_cachegen", "--ablate", "cachegen_fallback",
            "--ops", "30", "--dump-dir", str(tmp_path)]
    dump, replay = ((jmain, lambda a: tmain(a + ["--device", "cpu"]))
                    if direction == "reference_to_port"
                    else (lambda a: tmain(a + ["--device", "cpu"]), jmain))
    assert dump(args) == 1
    (path,) = tmp_path.glob("sim-repro-*.json")
    capsys.readouterr()
    assert replay(["--replay", str(path)]) == 0
    out = capsys.readouterr().out
    assert "replay reproduced the recorded interleaving exactly" in out
    assert "cachegen_loss" in out


# -- seeded-random property sweep ----------------------------------------------


def test_random_configs_agree_with_model_and_replay():
    for trial in range(5):
        seed = 1000 + trial
        rng = random.Random(seed)
        cfg = SimConfig(seed=seed, scenario=rng.choice(SIM_SCENARIOS),
                        fault=rng.choice(FAULT_PLANS), n_ops=22)
        r = run_sim(cfg, device="cpu")
        assert r.ok, (cfg, r.violations[:3])
        assert run_sim(cfg, device="cpu").trace_hash == r.trace_hash, cfg
        if cfg.fault != "cold_tier":
            assert r.trace_hash == jsim.run_sim(_ref_cfg(cfg)).trace_hash


# -- building blocks -----------------------------------------------------------


def test_virtual_clock_monotone():
    c = VirtualClock()
    assert c() == 0.0
    c.advance(1.5)
    assert c.time() == 1.5
    with pytest.raises(ValueError):
        c.advance(-1)


def test_step_scheduler_seeded_interleaving():
    def order_for(pkg, seed):
        sched = pkg.StepScheduler(seed, pkg.VirtualClock())
        sched.add_client("a", [{"op": i} for i in range(6)])
        sched.add_client("b", [{"op": i} for i in range(6)])
        seen = []
        sched.run(lambda step, client, op: seen.append((client, op["op"])))
        return seen

    import repro_torch.sim as tpkg

    o1, o2 = order_for(tpkg, 7), order_for(tpkg, 7)
    assert o1 == o2 and len(o1) == 12
    assert order_for(tpkg, 8) != o1
    assert [x for c, x in o1 if c == "a"] == list(range(6))
    assert o1 == order_for(jsim, 7)


def test_step_scheduler_deferred_actions_fire_in_order():
    clock = VirtualClock()
    sched = StepScheduler(0, clock)
    sched.add_client("a", [{"op": i} for i in range(8)])
    fired = []
    sched.defer(3, lambda: fired.append("x"))
    sched.defer(3, lambda: fired.append("y"))
    sched.run(lambda *_: None)
    assert fired == ["x", "y"]


def test_trace_recorder_hash_order_sensitive():
    a, b = TraceRecorder(), TraceRecorder()
    a.record(0, "c", "x", 1)
    a.record(1, "c", "y", 2)
    b.record(1, "c", "y", 2)
    b.record(0, "c", "x", 1)
    assert a.trace_hash != b.trace_hash
    assert a.n_events == 2
    j = jsim.TraceRecorder()
    j.record(0, "c", "x", 1)
    j.record(1, "c", "y", 2)
    assert j.trace_hash == a.trace_hash


def test_value_checksum_detects_torn_entry():
    v = make_value("kw", 3)
    assert v == jsim.make_value("kw", 3)
    assert not value_torn(v)
    assert value_torn({**v, "v": 4})
    assert value_torn({"k": "kw"})


def test_model_store_mirrors_replicated_crash_semantics():
    m = ModelStore(replication=2, capacity_per_node=8)
    for i in range(3):
        m.add_node(f"cache-{i}")
    m.insert_wave([("alpha", make_value("alpha", 1))])
    owners = m.ring.nodes_for("alpha", 2)
    m.crash(owners[0])
    got, strict = m.lookup("alpha")
    assert strict and got["v"] == 1
    m.restart(owners[0], recover=False)
    m.crash(owners[1])
    got, _ = m.lookup("alpha")
    assert got is None


# -- membership churn ----------------------------------------------------------


def test_membership_churn_plan_clean_and_deterministic():
    for scenario in ("skewed_reuse", "paraphrase_burst"):
        cfg = _cfg(seed=7, scenario=scenario, fault="membership_churn")
        r = run_both(cfg)
        assert r.ok, (scenario, r.violations[:3])
        assert run_sim(cfg, device="cpu").trace_hash == r.trace_hash


def test_model_store_join_and_drain_mirror_ring_changes():
    m = ModelStore(replication=2, capacity_per_node=64)
    for i in range(3):
        m.add_node(f"cache-{i}")
    m.insert_wave([(f"kw-{i}", make_value(f"kw-{i}", 1)) for i in range(20)])
    m.join("cache-3")
    assert all(m.lookup(f"kw-{i}")[0] is not None for i in range(20))
    m.drain("cache-0")
    assert "cache-0" not in m.nodes
    assert all(m.lookup(f"kw-{i}")[0] is not None for i in range(20))
    m.crash("cache-1")
    m.drain("cache-1")
    assert "cache-1" not in m.nodes


# -- async cache generation ----------------------------------------------------


def test_async_cachegen_plan_clean_and_race_actually_interleaved():
    cfg = _cfg(seed=5, fault="async_cachegen")
    r = run_both(cfg)
    assert r.ok, r.violations[:3]
    assert run_sim(cfg, device="cpu").trace_hash == r.trace_hash
    assert r.cachegen["submitted"] > 0
    assert r.ops_applied > cfg.n_ops * cfg.n_clients


def test_async_admission_race_regression_pinned_seed(tmp_path, capsys):
    rc = tmain(["--seed", "3", "--fault", "async_cachegen", "--ablate", "cachegen_fallback",
                "--ops", "30", "--dump-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 1
    assert "cachegen_loss" in capsys.readouterr().out
    (dump,) = tmp_path.glob("sim-repro-*.json")
    rc = tmain(["--replay", str(dump), "--dump-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "replay reproduced the recorded interleaving exactly" in out
    assert "cachegen_loss" in out


# -- ttl -----------------------------------------------------------------------


def test_ttl_churn_plan_clean_and_expiry_bites():
    cfg = _cfg(seed=9, fault="ttl_churn")
    r = run_both(cfg)
    assert r.ok, r.violations[:3]
    assert r.config.ttl_s == 0.05 and not r.config.fuzzy
    assert r.store_stats["misses"] > 0
    assert run_sim(cfg, device="cpu").span_digest == r.span_digest


def test_conditional_admission_regression_pinned_seed():
    cfg = _cfg(seed=3, fault="async_cachegen")
    r = run_both(cfg)
    assert r.ok, r.violations[:3]
    assert r.cold_stats["stale_insert_skips"] > 0
    b = run_sim(cfg, device="cpu")
    assert (b.trace_hash, b.span_digest) == (r.trace_hash, r.span_digest)
    assert b.cold_stats["stale_insert_skips"] == r.cold_stats["stale_insert_skips"]


# -- strict paraphrase scenarios -----------------------------------------------


def test_paraphrase_scenario_is_strict_and_fuzzy_hits_happen():
    r = run_both(_cfg(seed=2, scenario="paraphrase_burst"))
    assert r.ok, r.violations[:3]
    assert r.config.fuzzy
    assert r.store_stats["hits"] > 0


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_similarity_model_predicts_fuzzy_resolution(backend):
    m = ModelStore(replication=1, capacity_per_node=64, fuzzy=True, index_backend=backend,
                   device="cpu")
    for i in range(2):
        m.add_node(f"cache-{i}")
    v = make_value("average of two rows", 1)
    m.insert_wave([("average of two rows", v)])
    got, strict = m.lookup("average of two rows from table")
    assert strict and got == v
    got, strict = m.lookup("entirely unrelated query zz")
    assert got is None and strict


# -- speculative execution -----------------------------------------------------


def test_extra_plan_ablations_well_formed():
    assert EXTRA_PLAN_ABLATIONS == jsim.EXTRA_PLAN_ABLATIONS
    assert ALL_ABLATIONS == jsim.ALL_ABLATIONS
    for fault, guard in EXTRA_PLAN_ABLATIONS.items():
        assert fault in FAULT_PLANS
        assert guard in ALL_ABLATIONS
        assert guard != ABLATION_OF.get(fault)


def test_spec_rollback_ablation_fires_leak_oracle_only():
    r = run_both(_cfg(seed=3, fault="speculative_exec", ablate=("spec_rollback",)))
    assert {v.oracle for v in r.violations} == {"spec_leak"}
    assert r.speculation["forced_commits"] > 0
    assert r.speculation["pending"] == 0


def test_spec_verify_timeout_ablation_fires_liveness_oracle_only():
    r = run_both(_cfg(seed=3, fault="speculative_exec", ablate=("spec_verify_timeout",)))
    assert {v.oracle for v in r.violations} == {"spec_liveness"}
    assert r.speculation["pending"] > 0
    assert r.router_metrics["spec_dropped"] > 0


def test_spec_commit_vs_concurrent_overwrite_regression_pinned_seed():
    cfg = _cfg(seed=3, fault="speculative_exec")
    r = run_both(cfg)
    assert r.ok, r.violations[:3]
    assert r.speculation["stale_admit_races"] > 0
    assert r.speculation["commits"] > 0
    b = run_sim(cfg, device="cpu")
    assert (b.trace_hash, b.span_digest) == (r.trace_hash, r.span_digest)
    assert b.speculation == r.speculation


# -- intra-wave grouped recency mirroring --------------------------------------


def test_model_mirrors_intra_wave_grouped_recency():
    """Within one batched wave the store touches recency grouped per shard
    per tier; the model mirrors it, and the singular-lookup control shows
    the grouping really moves the LRU victim."""
    from repro_torch.core.fuzzy import similarity

    pairs = [("average of two rows", "average of two rows from table"),
             ("sum of one column", "sum of one column from table"),
             ("max minus min", "max minus min from table")]
    fillers = ["paint the fence bright green", "solve the quadratic equation",
               "walk the dog around town", "bake the sourdough loaf",
               "tune the violin strings", "chart the ocean currents"]

    def build():
        return DistributedPlanCache(2, replication=1, capacity_per_node=2, fuzzy=True)

    ring = build().ring
    chosen = None
    for x, q in pairs:
        if similarity(x, q) < 0.8 or ring.nodes_for(x, 1) == ring.nodes_for(q, 1):
            continue
        neutral = [f for f in fillers
                   if ring.nodes_for(f, 1) == ring.nodes_for(x, 1)
                   and similarity(f, q) < 0.8 and similarity(f, x) < 0.8]
        if len(neutral) >= 2:
            chosen = (x, q, neutral[0], neutral[1])
            break
    assert chosen
    x, q, y, z = chosen

    def play(batched):
        dc = build()
        m = ModelStore(replication=1, capacity_per_node=2, fuzzy=True)
        for i in range(2):
            m.add_node(f"cache-{i}")
        seed = [(x, make_value(x, 1)), (y, make_value(y, 1))]
        dc.insert_batch(seed)
        m.insert_wave(seed)
        if batched:
            got = dc.lookup_batch([q, y])
            want = [v for v, _ in m.lookup_wave([q, y])]
        else:
            got = [dc.lookup(q), dc.lookup(y)]
            want = [m.lookup(q)[0], m.lookup(y)[0]]
        assert got == want
        dc.insert(z, make_value(z, 1))
        m.insert_wave([(z, make_value(z, 1))])
        assert sorted(dc.keys()) == m.keys()
        return sorted(dc.keys())

    assert play(True) != play(False)


# -- the CLI -------------------------------------------------------------------


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.sim", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is CUDA here, and CUDA is present")
    p = _cli("--ops", "5", "--dump-dir", str(tmp_path))
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
