"""Serving entry point: APC two-tier agent serving on the port's torch engines.

    python -m repro_torch.launch.serve --env financebench --n 16 --full
    python -m repro_torch.launch.serve --env aime --method cascade --n 8

``--env`` takes any of the five workloads (``ALL_ENVS``) and ``--method``
any registered method. Runs the paper's pipeline end-to-end: keyword extraction -> plan-cache
routing -> small/large planner tier -> actor, with REAL torch engines
(smoke configs by default, the published configs with --full) on the GPU
(``--device cpu`` runs the plain PyTorch path on the CPU), and prints the
paper's headline metrics (cost, accuracy, latency, hit rate).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import zlib

import torch

from repro_torch.configs import registry
from repro_torch.configs.apc_minion import DEFAULT
from repro_torch.core.agent_loop import AgentConfig, PlanActAgent
from repro_torch.core.cost_model import CostLedger
from repro_torch.core.methods import method_names
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.envs.workloads import ALL_ENVS, get_env
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.serving.torch_backend import TorchBackend


def arch_seed(arch: str) -> int:
    """Weight seed of an arch, stable across processes (the reference's
    ``hash(arch)`` is salted per process)."""
    return zlib.crc32(arch.encode())


def engine_config(arch: str, *, full: bool = False):
    """The config an engine of ``arch`` serves: the published one with
    ``full``, else the smoke reduction. A vocabulary narrower than the
    backend tokenizer's is widened to it, so every prompt id is in range:
    the reference's 512-entry smoke vocab is not, nor is zamba2-2.7b's
    published 32,000 (the reference's ``jnp.take`` embeds such ids as NaN;
    the port's embedding raises on them)."""
    cfg = registry.get(arch) if full else registry.get_smoke(arch)
    vocab = HashTokenizer().vocab_size
    if cfg.vocab_size < vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg


def build_engine(arch: str, *, full: bool = False, max_len: int = 192, device=None):
    """An Engine of ``arch``: ``engine_config``'s config, random weights
    seeded by ``arch_seed``."""
    device = resolve_device(device)
    cfg = engine_config(arch, full=full)
    gen = torch.Generator(device=device).manual_seed(arch_seed(arch))
    return Engine(cfg, lm.init_params(cfg, gen, device), max_len=max_len, device=device)


def build_engines(deployment, *, full: bool = False, max_len: int = 192, device=None):
    """One Engine per distinct arch of the deployment's roles (``build_engine``
    of each); roles that use the same arch share it."""
    roles = {
        "large_planner": deployment.large_planner,
        "small_planner": deployment.small_planner,
        "actor": deployment.actor,
        "keyword_extractor": deployment.keyword_extractor,
    }
    engines = {}
    cache = {}
    for role, arch in roles.items():
        if arch not in cache:
            cache[arch] = build_engine(arch, full=full, max_len=max_len, device=device)
        engines[role] = cache[arch]
    return engines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="financebench", choices=ALL_ENVS)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--method", default="apc", choices=method_names())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--cache-capacity", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    deployment = DEFAULT
    print(f"[serve] tiers: large={deployment.large_planner} "
          f"small={deployment.small_planner} actor={deployment.actor}")
    engines = build_engines(deployment, full=args.full, device=args.device)
    backend = TorchBackend(engines, seed=0)
    ledger = CostLedger(pricing_map=dict(deployment.pricing))
    agent = PlanActAgent(
        backend, ledger,
        AgentConfig(method=args.method, cache_capacity=args.cache_capacity,
                    index_device=args.device),
    )

    env = get_env(args.env)
    tasks = env.generate(args.n, seed=0)
    t0 = time.time()
    correct = hits = 0
    for i, t in enumerate(tasks):
        rec = agent.run_task(t)
        correct += rec.correct
        hits += rec.hit
        if (i + 1) % 10 == 0:
            print(f"[serve] {i+1}/{args.n} acc={correct/(i+1):.2f} "
                  f"hit={hits/(i+1):.2f} cost=${ledger.total_cost():.3f}")
    wall = time.time() - t0
    dev = next(iter(engines.values())).device
    print(f"[serve] method={args.method} n={args.n} device={dev}")
    print(f"  accuracy      {correct/args.n:.3f}")
    print(f"  hit rate      {hits/args.n:.3f}")
    print(f"  cost          ${ledger.total_cost():.4f}  (paper Table 8 prices)")
    print(f"  modeled lat.  {ledger.total_latency():.1f}s")
    print(f"  wall ({dev.type})   {wall:.1f}s")
    print(f"  engine rates  { {r: {k: round(v,1) for k,v in e.measured_rates().items()} for r, e in engines.items()} }")
    print(f"  cache entries {len(agent.cache)}")


if __name__ == "__main__":
    main()
