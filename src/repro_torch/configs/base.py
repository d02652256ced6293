"""Model configuration for the port: the dense, ssm and hybrid fields of
``repro.configs.base.ModelConfig`` and its smoke reduction.

Frozen dataclasses, as in the reference, so configs hash and compare.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention configuration."""

    state_dim: int = 64  # per-head state width (d_state)
    head_dim: int = 64
    expand: int = 2  # mamba2 inner expansion (d_inner = expand * d_model)
    conv_dim: int = 4  # depthwise conv width (mamba2)
    chunk_size: int = 128  # chunk of the plain chunked scans


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid in this port
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

    # --- recurrent families ---
    ssm: Optional[SSMConfig] = None
    # attn_every = 0: attention-free (ssm); 1: attention in every layer
    # (dense); k > 1: one shared attention block after every k SSM layers
    # (hybrid)
    attn_every: int = 1

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
    kw: Dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk_size=16)
    if cfg.attn_every > 1:
        kw["num_layers"] = 4
        kw["attn_every"] = 2
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
