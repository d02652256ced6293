"""Traced quickstart: drive the serving path with tracing and metrics on
(the twin of ``python -m repro.obs``, with its CLI and workload).

    python -m repro_torch.obs --out-dir trace-out [--requests 24] [--nodes 2] [--batch 6]

Builds a fuzzy :class:`DistributedPlanCache` behind a :class:`TwoTierRouter`
whose planners are lambdas (no model runs), routes a few admission waves
(repeats and paraphrases, so exact and fuzzy hits both occur) and writes:

* ``trace.jsonl``        — one canonical JSON span per line
* ``trace_chrome.json``  — the Chrome trace-event timeline
* ``metrics.json``       — the registry snapshot

``python tools/check_trace.py --dir trace-out`` validates these artifacts.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

from repro_torch.core.distributed_cache import DistributedPlanCache
from repro_torch.obs import (
    InMemoryExporter,
    JsonlExporter,
    MetricsRegistry,
    Tracer,
    use_tracer,
    write_chrome_trace,
)
from repro_torch.serving.router import TwoTierRouter


def _requests(n: int) -> List[dict]:
    """A workload with guaranteed repeats and near-duplicates: round r of
    the same keyword set re-arrives with light paraphrasing."""
    base = [
        "book flight to tokyo",
        "summarize quarterly report",
        "plan team offsite",
        "debug pallas kernel",
        "write launch email",
        "review pull request",
    ]
    out = []
    for i in range(n):
        kw = base[i % len(base)]
        if (i // len(base)) % 2 == 1:
            kw = kw + " please"  # paraphrase: lands on the fuzzy stage
        out.append({"query": kw})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="trace-out")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=6)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    registry = MetricsRegistry()
    mem = InMemoryExporter()
    jsonl_path = os.path.join(args.out_dir, "trace.jsonl")
    tracer = Tracer(exporters=[mem, JsonlExporter(jsonl_path)])

    cache = DistributedPlanCache(
        n_nodes=args.nodes, fuzzy=True, capacity_per_node=64, obs=registry
    )
    router = TwoTierRouter(
        cache,
        extract_keyword=lambda r: r["query"],
        plan_large=lambda r: {"plan": f"fresh plan for {r['query']}"},
        plan_small_with_template=lambda r, t: {"plan": "adapted", "from": t},
        make_template=lambda r, res: res["plan"],
        async_cachegen=True,
    )

    reqs = _requests(args.requests)
    with use_tracer(tracer):
        for i in range(0, len(reqs), args.batch):
            router.route_batch(reqs[i : i + args.batch])
        router.drain()
    router.close()
    tracer.close()

    chrome_path = os.path.join(args.out_dir, "trace_chrome.json")
    write_chrome_trace(chrome_path, mem.spans)
    metrics_path = os.path.join(args.out_dir, "metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(registry.snapshot(), f, sort_keys=True, indent=1)
        f.write("\n")

    m = router.metrics.snapshot()
    print(f"routed {m['requests']} requests  "
          f"hit_rate={m['hit_rate']:.2f}  tokens_saved={m['tokens_saved']}")
    print(f"spans: {tracer.n_spans}  digest={mem.digest()}")
    for p in (jsonl_path, chrome_path, metrics_path):
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
