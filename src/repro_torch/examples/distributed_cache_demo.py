"""Distributed plan cache: sharding, replication, failure, elastic scaling
(the twin of ``examples/distributed_cache_demo.py``).

    python -m repro_torch.examples.distributed_cache_demo [--device cpu]

Shows the deployment-scale behaviour of the APC test-time memory: keywords
consistent-hash-sharded over cache nodes with replication; node failures
served from replicas; elastic add/remove moving only ~K/N keys. The shards
match exactly, on the host; ``--device`` is where a shard's ``pallas`` or
``device`` index would search.
"""

from __future__ import annotations

import argparse

from repro_torch.core.distributed_cache import DistributedPlanCache
from repro_torch.core.harness import run_workload
from repro_torch.models.common import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== populate a 6-node replicated cache from a real APC run ==")
    dc = DistributedPlanCache(6, replication=2, capacity_per_node=64, device=device)
    res = run_workload("financebench", "apc", 120, cache=dc)
    print(f"run: accuracy={res.accuracy:.2f} hit_rate={res.hit_rate:.2f} "
          f"entries={len(dc)}")
    print("load by node:", dc.load_by_node())

    print("\n== crash one node: replicas keep serving ==")
    keys = dc.keys()
    dc.mark_down("cache-3")
    survive = sum(dc.lookup(k) is not None for k in keys)
    print(f"after cache-3 down: {survive}/{len(keys)} keys still served")

    print("\n== elastic scale-out: add two nodes ==")
    before = {k: True for k in dc.keys()}
    dc.add_node("cache-6")
    dc.add_node("cache-7")
    print("load by node:", dc.load_by_node())
    still = sum(dc.lookup(k) is not None for k in before)
    print(f"all keys reachable after rescale: {still}/{len(before)}")

    print("\n== graceful decommission (keys re-homed, not lost) ==")
    dc.mark_up("cache-3")
    dc.remove_node("cache-0")
    still = sum(dc.lookup(k) is not None for k in before)
    print(f"after removing cache-0: {still}/{len(before)} keys reachable")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
