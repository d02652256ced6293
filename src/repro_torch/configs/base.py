"""Model configuration for the port: the dense fields of
``repro.configs.base.ModelConfig`` and its smoke reduction.

Frozen dataclasses, as in the reference, so configs hash and compare.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" in this port so far
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention features ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # --- mlp / norm features ---
    mlp_act: str = "swiglu"  # swiglu | squared_relu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np
    tie_embeddings: bool = False

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- provenance ---
    source: str = ""

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to CPU-smoke scale (as ``repro`` does)."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
