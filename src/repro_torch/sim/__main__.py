"""CLI for the deterministic simulation harness (the twin of
``python -m repro.sim``, plus ``--device``).

Modes:

* single run — ``python -m repro_torch.sim --seed 7 --fault crash_restart``:
  runs once, reruns to verify determinism, prints the trace hash and any
  oracle violations (exit 1 on violation or hash mismatch);
* matrix — ``python -m repro_torch.sim --check --seeds 5``: the CI gate.
  Runs every (seed × scenario × fault-plan) cell with guards ON (must be
  clean and deterministic) and, unless ``--no-ablation-audit``, re-runs each
  guard with it ablated and requires an oracle to FIRE;
* replay — ``python -m repro_torch.sim --replay FILE``: re-executes a
  dumped failure seed (of either package) and verifies the trace hash
  reproduces bit for bit.

``--device`` (default ``cuda``; ``cpu`` on a machine without a card) is
where the fuzzy cells' similarity indexes run: on CUDA the ``device``
backend, whose lookups launch the top-k kernel; on the CPU the reference's
``auto``. On any red cell a replayable repro JSON is dumped under
``--dump-dir``; it records the device beside the config, never in it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Tuple

from repro_torch.envs.workloads import SIM_SCENARIOS
from repro_torch.sim.faults import (
    ABLATION_OF,
    ALL_ABLATIONS,
    EXTRA_PLAN_ABLATIONS,
    FAULT_PLANS,
    SCENARIO_ABLATION_OF,
)
from repro_torch.sim.harness import SimConfig, run_sim
from repro_torch.sim.trace import TraceRecorder

# plans that pin their own scenario (SimConfig.normalized) run once per seed
# under it; other scenario pairings would be duplicate cells
PINNED_SCENARIO = {"mid_wave_evict": "evict_then_hit",
                   "cold_tier": "evict_then_hit",
                   "ttl_churn": "skewed_reuse",
                   "speculative_exec": "paraphrase_burst"}


def matrix_cells(seed: int, n_ops: int = 60) -> Tuple[List[Tuple[str, SimConfig]],
                                                      List[Tuple[str, SimConfig]]]:
    """The ``--check`` matrix at one seed: ``(clean, audit)`` lists of
    ``(tag, config)``. Clean cells (every scenario under every plan that
    does not pin another scenario) must show no violation; audit cells (each
    guard ablated: the fault-plan guards, the scenario-tied guards at
    replication 1, where a lost scatter has no replica tier to hide behind,
    and the plans' extra guards) must trip an oracle."""
    clean = [
        (f"s{seed}-{scenario}-{fault}",
         SimConfig(seed=seed, scenario=scenario, fault=fault, n_ops=n_ops))
        for scenario in SIM_SCENARIOS
        for fault in FAULT_PLANS
        if PINNED_SCENARIO.get(fault, scenario) == scenario
    ]
    audit = [
        SimConfig(seed=seed, fault=fault, n_ops=n_ops, ablate=(guard,))
        for fault, guard in sorted(ABLATION_OF.items())
    ] + [
        SimConfig(seed=seed, scenario=scenario, n_ops=n_ops, replication=1,
                  ablate=(guard,))
        for scenario, guard in sorted(SCENARIO_ABLATION_OF.items())
    ] + [
        SimConfig(seed=seed, fault=fault, n_ops=n_ops, ablate=(guard,))
        for fault, guard in sorted(EXTRA_PLAN_ABLATIONS.items())
    ]
    return clean, [(f"s{seed}-ablate-{cfg.ablate[0]}", cfg) for cfg in audit]


def _fail_dump(report, dump_dir: str, tag: str) -> str:
    """Write a self-contained, replayable failure seed (CI artifact)."""
    path = os.path.join(dump_dir, f"sim-repro-{tag}.json")
    payload = {
        "config": dataclasses.asdict(report.config),
        "device": report.device,
        "index_backend": report.index_backend,
        "trace_hash": report.trace_hash,
        "span_digest": report.span_digest,
        "violations": [dataclasses.asdict(v) for v in report.violations],
        "store_stats": report.store_stats,
        "router_metrics": report.router_metrics,
        "trace_tail": report.trace_tail,  # event log for post-mortems
        "how_to_replay": "PYTHONPATH=src python -m repro_torch.sim --replay <this file>",
    }
    os.makedirs(dump_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=repr)
        f.write("\n")
    return path


def _run_once(cfg: SimConfig, device: str, *, verify_determinism: bool = True):
    """Run once; on verify, rerun and return (trace_hash, span_digest) —
    both must match for the cell to count as deterministic."""
    report = run_sim(cfg, device=device)
    rerun = None
    if verify_determinism:
        r2 = run_sim(cfg, device=device)
        rerun = (r2.trace_hash, r2.span_digest)
    return report, rerun


def cmd_single(args) -> int:
    cfg = SimConfig(
        seed=args.seed, scenario=args.scenario, fault=args.fault,
        n_ops=args.ops, ablate=tuple(args.ablate.split(",")) if args.ablate else (),
    )
    report, rerun = _run_once(cfg, args.device)
    print(f"seed={args.seed} scenario={report.config.scenario} "
          f"fault={report.config.fault} ablate={report.config.ablate or '-'} "
          f"device={report.device} index={report.index_backend}")
    print(f"steps={report.steps} ops={report.ops_applied} "
          f"lookups={report.lookups} inserts={report.inserts}")
    print(f"trace_hash={report.trace_hash}")
    print(f"span_digest={report.span_digest} spans={report.n_spans}")
    print(f"store_stats={json.dumps(report.store_stats, sort_keys=True)}")
    if report.router_metrics:
        print(f"router={json.dumps(report.router_metrics, sort_keys=True)}")
    ok = True
    if rerun is not None and rerun != (report.trace_hash, report.span_digest):
        print(f"NONDETERMINISTIC: rerun {rerun} != "
              f"{(report.trace_hash, report.span_digest)}")
        ok = False
    for v in report.violations:
        print(f"VIOLATION step={v.step} oracle={v.oracle}: {v.detail}")
    if report.violations:
        ok = False
    if not ok:
        path = _fail_dump(report, args.dump_dir,
                          f"s{args.seed}-{report.config.scenario}-"
                          f"{report.config.fault}")
        print(f"repro dumped: {path}")
    print("OK" if ok else "RED")
    return 0 if ok else 1


def cmd_check(args) -> int:
    """CI matrix: seeds x scenarios x fault plans, guards on + ablation audit."""
    red: List[str] = []
    cells = 0
    for seed in range(args.seeds):
        clean, audit = matrix_cells(seed, args.ops)
        for tag, cfg in clean:
            cells += 1
            report, rerun = _run_once(cfg, args.device)
            if report.violations:
                red.append(f"{tag}: {report.violations[0].oracle}: "
                           f"{report.violations[0].detail}")
                _fail_dump(report, args.dump_dir, tag)
            elif rerun != (report.trace_hash, report.span_digest):
                red.append(f"{tag}: nondeterministic trace/span stream")
                _fail_dump(report, args.dump_dir, tag)
        if args.ablation_audit:
            # every ablated guard must trip its oracle
            for tag, cfg in audit:
                cells += 1
                report = run_sim(cfg, device=args.device)
                if not report.violations:
                    red.append(f"{tag}: guard ablated but NO oracle fired "
                               "(the sim lost its teeth)")
                    _fail_dump(report, args.dump_dir, tag)
    print(f"sim-check: {cells} cells, {len(red)} red")
    for r in red:
        print(f"RED {r}")
    return 1 if red else 0


def cmd_replay(args) -> int:
    payload = TraceRecorder.load_repro(args.replay)
    cfg_d = dict(payload["config"])
    cfg_d["ablate"] = tuple(cfg_d.get("ablate", ()))
    cfg = SimConfig(**cfg_d)
    report = run_sim(cfg, device=args.device)
    want = payload["trace_hash"]
    print(f"replayed {args.replay}: trace_hash={report.trace_hash} "
          f"(recorded {want})")
    for v in report.violations:
        print(f"VIOLATION step={v.step} oracle={v.oracle}: {v.detail}")
    if report.trace_hash != want:
        print("REPLAY DIVERGED")
        return 1
    print("replay reproduced the recorded interleaving exactly")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="Deterministic fault-injection simulation of the "
                    "distributed plan cache (see repro_torch.sim docs).",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", default="skewed_reuse",
                    choices=list(SIM_SCENARIOS))
    ap.add_argument("--fault", default="none", choices=list(FAULT_PLANS))
    ap.add_argument("--ops", type=int, default=60,
                    help="ops per simulated client (4 clients)")
    ap.add_argument("--ablate", default="",
                    help="comma-joined guard ablations "
                         f"({list(ALL_ABLATIONS)})")
    ap.add_argument("--check", action="store_true",
                    help="run the seeds x scenarios x faults CI matrix")
    ap.add_argument("--seeds", type=int, default=5,
                    help="seed count for --check")
    ap.add_argument("--no-ablation-audit", dest="ablation_audit",
                    action="store_false",
                    help="skip the guard-ablation oracle audit in --check")
    ap.add_argument("--replay", default="",
                    help="replay a dumped sim-repro JSON file")
    ap.add_argument("--dump-dir", default="sim-repro",
                    help="where failure repro seeds are written")
    ap.add_argument("--device", default="cuda",
                    help="where the similarity indexes run (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.replay:
        return cmd_replay(args)
    if args.check:
        return cmd_check(args)
    return cmd_single(args)


if __name__ == "__main__":
    sys.exit(main())
