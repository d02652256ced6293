"""The paper's own deployment: APC on a Minion-style Plan-Act agent.

The paper (§4.1) used GPT-4o as the large planner, LLaMa-3.1-8B as both the
small planner and the actor, and GPT-4o-mini for keyword extraction / cache
generation. Here the tiers are drawn from the open model zoo, preserving
the size ordering:

    large planner   : nemotron-4-15b
    small planner   : olmo-1b
    actor           : qwen2.5-3b
    keyword/cachegen: olmo-1b

Token prices for the $-cost model come straight from the paper's Table 8 so
dollar figures stay comparable with the paper.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class TierPricing:
    """$ per million tokens (paper Table 8)."""

    input_per_m: float
    output_per_m: float


# Paper Table 8, verbatim.
PAPER_PRICES: Dict[str, TierPricing] = {
    "gpt-4o": TierPricing(2.50, 10.00),
    "gpt-4o-mini": TierPricing(0.15, 0.60),
    "claude-3.5-sonnet": TierPricing(3.00, 15.00),
    "llama-3.1-8b": TierPricing(0.18, 0.18),
    "llama-3.2-3b": TierPricing(0.06, 0.06),
    "qwen-2.5-7b": TierPricing(0.30, 0.30),
}


@dataclass(frozen=True)
class APCDeployment:
    """Which arch plays which APC role, and how each role is priced."""

    large_planner: str = "nemotron-4-15b"
    small_planner: str = "olmo-1b"
    actor: str = "qwen2.5-3b"
    keyword_extractor: str = "olmo-1b"
    # price table role -> Table 8 model (keeps $ comparable to the paper)
    pricing: Dict[str, str] = field(
        default_factory=lambda: {
            "large_planner": "gpt-4o",
            "small_planner": "llama-3.1-8b",
            "actor": "llama-3.1-8b",
            "keyword_extractor": "gpt-4o-mini",
            "cache_generator": "gpt-4o-mini",
        }
    )


DEFAULT = APCDeployment()
