"""Quickstart: the APC pipeline in ~40 lines (the twin of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Runs FinanceBench-style tasks through every method registered in the
``repro_torch.memory`` method registry (the paper's baselines, APC, and the
exact->fuzzy->semantic ``cascade`` hybrid) and prints the paper's headline
comparison against the accuracy-optimal baseline. The harness drives a
``SimulatedBackend`` (no engines); ``--device`` is where a ``pallas`` or
``device`` index would search, and the default ``auto`` index searches on
the host, so no tensor reaches the card.

A row's latency is the simulated latency of the tasks plus the cache
lookups' measured time. Standard output is the reference's lines; standard
error gets one ``latency split:`` line, a JSON object of each method's two
parts (``simulated_s``, deterministic, and ``lookup_s``, measured), so a
check can hold the simulated part exactly on any host.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.agent_loop import AgentConfig
from repro_torch.core.harness import run_workload
from repro_torch.core.methods import method_names
from repro_torch.models.common import resolve_device

N = 120  # cold-start dominates below ~50 tasks; 120 shows steady-state savings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    print(f"{'method':20s} {'accuracy':>9s} {'cost $':>8s} {'latency s':>10s} {'hit%':>6s}")
    results = {}
    for method in method_names():  # enumerated from the registry, not a hand-kept list
        r = run_workload("financebench", method, N, keep_records=True,
                         agent_cfg=AgentConfig(method=method, index_device=device))
        results[method] = r
        print(f"{method:20s} {r.accuracy:9.3f} {r.cost:8.3f} "
              f"{r.latency_s:10.1f} {100*r.hit_rate:5.1f}%")

    apc, ao = results["apc"], results["accuracy_optimal"]
    print(f"\nAPC vs accuracy-optimal: "
          f"cost -{100*(1-apc.cost/ao.cost):.1f}%, "
          f"latency -{100*(1-apc.latency_s/ao.latency_s):.1f}%, "
          f"accuracy kept {100*apc.accuracy/ao.accuracy:.1f}% "
          f"(paper: -50.31%, -27.28%, 96.61%)")
    split = {m: {"simulated_s": sum(x.latency_s - x.cache_lookup_s for x in r.records),
                 "lookup_s": sum(x.cache_lookup_s for x in r.records)}
             for m, r in results.items()}
    print("latency split: " + json.dumps(split), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
