"""Workload harness: run (env x method) and aggregate the paper's metrics
(the twin of ``repro.core.harness``). It drives a ``SimulatedBackend``: no
engines and no device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.configs.apc_minion import APCDeployment, DEFAULT
from repro_torch.core.agent_loop import AgentConfig, PlanActAgent, RunRecord
from repro_torch.core.backends import (
    DEFAULT_QUALITY,
    DEFAULT_TOKENS,
    QualityProfile,
    SimulatedBackend,
    TokenProfile,
)
from repro_torch.core.cache import PlanCache
from repro_torch.core.cost_model import CostLedger
from repro_torch.envs.workloads import get_env


@dataclass
class WorkloadResult:
    env: str
    method: str
    n: int
    accuracy: float
    cost: float
    latency_s: float
    hit_rate: float
    hit_accuracy: Optional[float]
    miss_accuracy: Optional[float]
    breakdown: Dict[str, Dict[str, float]]
    records: List[RunRecord] = field(default_factory=list)
    cache_entries: int = 0

    def row(self) -> Dict[str, Any]:
        return {
            "env": self.env,
            "method": self.method,
            "n": self.n,
            "accuracy": round(self.accuracy, 4),
            "cost": round(self.cost, 4),
            "latency_s": round(self.latency_s, 1),
            "hit_rate": round(self.hit_rate, 4),
            "hit_acc": None if self.hit_accuracy is None else round(self.hit_accuracy, 4),
            "miss_acc": None if self.miss_accuracy is None else round(self.miss_accuracy, 4),
            "cache_entries": self.cache_entries,
        }


def run_workload(
    env_name: str,
    method: str,
    n: int = 200,
    *,
    seed: int = 0,
    deployment: APCDeployment = DEFAULT,
    agent_cfg: Optional[AgentConfig] = None,
    quality: QualityProfile = DEFAULT_QUALITY,
    tokens: TokenProfile = DEFAULT_TOKENS,
    cache: Optional[PlanCache] = None,
    keep_records: bool = False,
) -> WorkloadResult:
    env = get_env(env_name)
    tasks = env.generate(n, seed=seed)
    cfg = agent_cfg or AgentConfig(method=method)
    cfg.method = method
    backend = SimulatedBackend(quality=quality, tokens=tokens, seed=seed)
    ledger = CostLedger(pricing_map=dict(deployment.pricing))
    agent = PlanActAgent(backend, ledger, cfg, cache=cache)

    records: List[RunRecord] = []
    prev_cost = 0.0
    for t in tasks:
        rec = agent.run_task(t)
        rec.cost, prev_cost = rec.cost - prev_cost, rec.cost  # per-task delta
        records.append(rec)

    hits = [r for r in records if r.hit]
    misses = [r for r in records if not r.hit]
    acc = sum(r.correct for r in records) / max(1, len(records))
    res = WorkloadResult(
        env=env_name,
        method=method,
        n=n,
        accuracy=acc,
        cost=ledger.total_cost(),
        latency_s=sum(r.latency_s for r in records),
        hit_rate=len(hits) / max(1, len(records)),
        hit_accuracy=(sum(r.correct for r in hits) / len(hits)) if hits else None,
        miss_accuracy=(sum(r.correct for r in misses) / len(misses)) if misses else None,
        breakdown=ledger.breakdown(),
        records=records if keep_records else [],
        cache_entries=len(agent.cache),
    )
    return res


# METHODS is derived from the repro_torch.memory method registry (importing
# repro_torch.core.methods registers the built-ins, including the beyond-paper
# `cascade` hybrid). It is resolved LIVE via module __getattr__ so a
# method registered after this module was imported still shows up in
# `harness.METHODS` — note that `from repro_torch.core.harness import METHODS`
# snapshots at the importing module's import time, so enumerators that
# must see late registrations should call method_names() instead.
from repro_torch.core.methods import method_names


def __getattr__(name: str):
    if name == "METHODS":
        return method_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
