"""Token-level cost & latency accounting.

Dollar costs use the paper's Table 8 API prices so benchmark figures stay
comparable with the paper. Latency uses a serving-rate model: when a torch
data plane is attached, rates come from the engine's measurements; otherwise
from the published-API throughput defaults below (tokens/s), matching the
paper's remote-API setting.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.apc_minion import PAPER_PRICES, TierPricing

# tokens/second + per-call RTT defaults (remote-API regime, calibrated to the
# paper's Table 3 wall-clock); overridable per role, and replaced by
# engine-derived rates when a torch data plane is attached.
DEFAULT_RATES = {
    "large_planner": {"prefill": 5_000.0, "decode": 58.0, "rtt": 0.35},
    "small_planner": {"prefill": 12_000.0, "decode": 110.0, "rtt": 0.30},
    "actor": {"prefill": 12_000.0, "decode": 120.0, "rtt": 0.30},
    "keyword_extractor": {"prefill": 20_000.0, "decode": 60.0, "rtt": 0.30},
    "cache_generator": {"prefill": 20_000.0, "decode": 60.0, "rtt": 0.35},
}


@dataclass
class Usage:
    input_tokens: int = 0
    output_tokens: int = 0
    calls: int = 0
    latency_s: float = 0.0

    def add(self, inp: int, out: int, latency: float = 0.0):
        self.input_tokens += inp
        self.output_tokens += out
        self.calls += 1
        self.latency_s += latency


@dataclass
class CostLedger:
    """Accumulates per-role token usage; prices via a role->model mapping."""

    pricing_map: Dict[str, str]  # role -> Table 8 model name
    rates: Dict[str, Dict[str, float]] = field(default_factory=lambda: dict(DEFAULT_RATES))
    usage: Dict[str, Usage] = field(default_factory=lambda: defaultdict(Usage))

    def record(self, role: str, input_tokens: int, output_tokens: int) -> float:
        """Record a call; returns its modeled latency in seconds."""
        r = self.rates.get(role, DEFAULT_RATES["actor"])
        latency = (
            r.get("rtt", 0.0)
            + input_tokens / r["prefill"]
            + output_tokens / r["decode"]
        )
        self.usage[role].add(input_tokens, output_tokens, latency)
        return latency

    def price(self, role: str) -> TierPricing:
        return PAPER_PRICES[self.pricing_map.get(role, "llama-3.1-8b")]

    def cost_of(self, role: str) -> float:
        u = self.usage[role]
        p = self.price(role)
        return (u.input_tokens * p.input_per_m + u.output_tokens * p.output_per_m) / 1e6

    def total_cost(self) -> float:
        return sum(self.cost_of(r) for r in self.usage)

    def total_latency(self) -> float:
        return sum(u.latency_s for u in self.usage.values())

    def breakdown(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for role, u in sorted(self.usage.items()):
            out[role] = {
                "cost": round(self.cost_of(role), 6),
                "input_tokens": u.input_tokens,
                "output_tokens": u.output_tokens,
                "calls": u.calls,
                "latency_s": round(u.latency_s, 3),
            }
        return out

    def merge(self, other: "CostLedger") -> None:
        """Add ``other``'s usage role by role (tokens, calls, latency); the
        pricing stays this ledger's."""
        for role, u in other.usage.items():
            self.usage[role].input_tokens += u.input_tokens
            self.usage[role].output_tokens += u.output_tokens
            self.usage[role].calls += u.calls
            self.usage[role].latency_s += u.latency_s


def estimate_tokens(text: str) -> int:
    """chars/4 heuristic (matches OpenAI's rule of thumb)."""
    return max(1, len(text) // 4)
