"""End-to-end driver: serve through the full APC serving stack (keyword
extraction, plan-cache routing, two-tier planners, actor) on the port's
torch engines (the twin of ``examples/serve_agent.py``).

    python -m repro_torch.examples.serve_agent [--n 30] [--env tabmwp] [--full] [--device cpu]

The paper's deployment in miniature: every control-plane LM call runs on a
torch engine (smoke widths by default, the published widths with
``--full``) on the GPU unless ``--device cpu``. The engines are
``launch/serve.py``'s: vocabularies narrower than the tokenizer's are
widened to it (the reference's smoke engines embed those ids as NaN), and
each arch's weights are seeded by ``arch_seed``. Which plan, keyword and
answer each call yields comes from the simulated behavioural layer, so the
hits, accuracy, cost and tokens served do not depend on the widths.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.apc_minion import DEFAULT
from repro_torch.core.agent_loop import AgentConfig, PlanActAgent
from repro_torch.core.cost_model import CostLedger
from repro_torch.envs.workloads import get_env
from repro_torch.launch.serve import build_engine
from repro_torch.models.common import resolve_device
from repro_torch.serving.torch_backend import TorchBackend

MAX_LEN = 160  # the reference example's engine length


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--env", default="tabmwp")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    dep = DEFAULT
    print(f"tiers: large={dep.large_planner}  small={dep.small_planner}  "
          f"actor={dep.actor}  ({'published' if args.full else 'reduced'} configs, "
          f"device {device})")
    engines, built = {}, {}
    for role, arch in (("large_planner", dep.large_planner),
                       ("small_planner", dep.small_planner),
                       ("actor", dep.actor),
                       ("keyword_extractor", dep.keyword_extractor)):
        if arch not in built:
            built[arch] = build_engine(arch, full=args.full, max_len=MAX_LEN, device=device)
        engines[role] = built[arch]

    backend = TorchBackend(engines, seed=0)
    ledger = CostLedger(pricing_map=dict(dep.pricing))
    agent = PlanActAgent(backend, ledger, AgentConfig(method="apc", index_device=str(device)))

    tasks = get_env(args.env).generate(args.n, seed=0)
    t0 = time.time()
    ok = hits = 0
    for i, t in enumerate(tasks):
        rec = agent.run_task(t)
        ok += rec.correct
        hits += rec.hit
        tag = "HIT " if rec.hit else "MISS"
        if i < 8 or (i + 1) % 10 == 0:
            print(f"  [{i+1:3d}] {tag} kw={rec.keyword[:34]:36s} "
                  f"correct={rec.correct}")
    print(f"\nn={args.n}  accuracy={ok/args.n:.2f}  hit_rate={hits/args.n:.2f}  "
          f"cost=${ledger.total_cost():.3f}  wall={time.time()-t0:.1f}s")
    print("engine tokens served:",
          {r: e.stats.prefill_tokens + e.stats.decode_tokens
           for r, e in engines.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
