"""Configuration for the port: the fields of
``repro.configs.base.ModelConfig`` that the port's families read (dense,
moe, ssm, hybrid, vlm and audio), its sub-configs and its smoke reduction;
the four input shapes (``ShapeConfig``, ``SHAPES``); and the deployment
layer, ``ShardingProfile`` (how a model is laid out on a mesh) and
``DeploymentConfig``, with every field and default of the reference's.

Frozen dataclasses, as in the reference, so configs hash and compare.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts layer configuration (GShard/Megablox-style)."""

    num_experts: int
    experts_per_token: int  # top-k
    d_ff_expert: int
    capacity_factor: float = 1.25
    # "dense": GShard one-hot dispatch einsums. "ep": expert parallelism
    # over a mesh (all_to_all dispatch); without a mesh the exact dropless
    # grouped path.
    mode: str = "dense"
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # the EP path's knobs: the dispatch payload's wire dtype (auto = x's |
    # bfloat16 | float32 | float8_e4m3fn) and the token chunks a dispatch
    # is split into
    a2a_dtype: str = "auto"
    dispatch_chunks: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention configuration."""

    state_dim: int = 64  # per-head state width (d_state)
    head_dim: int = 64
    expand: int = 2  # mamba2 inner expansion (d_inner = expand * d_model)
    conv_dim: int = 4  # depthwise conv width (mamba2)
    chunk_size: int = 128  # chunk of the plain chunked scans
    # mamba2 B/C groups: head h reads group h // (heads / n_groups), and the
    # gated RMSNorm is taken over each group's d_inner / n_groups channels.
    # Port only (the reference's mamba2 shares one B/C by every head).
    n_groups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper)."""

    num_layers: int
    num_frames: int = 1500  # stub frontend emits this many frames
    frame_dim: int = 384


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | audio | nemotron_h
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention features ---
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_chunk: int = 2048  # the training path's attention block (flash_attention_chunked)
    rope_theta: float = 10_000.0
    rope_type: str = "rope"  # rope | mrope | none
    attn_logit_softcap: float = 0.0

    # --- mlp / norm features ---
    mlp_act: str = "swiglu"  # swiglu | squared_relu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_np
    tie_embeddings: bool = False

    # --- optional subsystems ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # attn_every = 0: attention-free (ssm); 1: attention in every layer
    # (dense); k > 1: one shared attention block after every k SSM layers
    # (hybrid)
    attn_every: int = 1

    # nemotron_h: one character a layer, the published
    # ``hybrid_override_pattern`` (M mamba2, - MLP, * attention); layer i
    # is of kind ``hybrid_pattern[i]``. Port only.
    hybrid_pattern: str = ""
    # the norms' epsilon; None keeps the reference's (1e-6 for RMSNorm,
    # 1e-5 for LayerNorm). Port only.
    norm_eps: Optional[float] = None

    # --- frontend stub (modality models) ---
    frontend: str = "none"  # none | patch_embed | audio_frames

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

    @property
    def is_attention_free(self) -> bool:
        return self.attn_every == 0

    @property
    def num_attn_layers(self) -> int:
        """How many attention applications exist (KV-cache slots)."""
        if self.attn_every == 0:
            return 0
        if self.encoder is not None:
            return self.num_layers  # decoder self-attn layers
        return self.num_layers // self.attn_every

    @property
    def supports_subquadratic_decode(self) -> bool:
        """long_500k eligibility: SSM / hybrid / linear-attention families."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula
        (``repro.configs.base.ModelConfig.param_count``). The reference
        branches on ``ssm.kind`` and ``shared_attention``, fields the port
        does not keep: here the hybrid family is its mamba2 kind with one
        shared attention block, the ssm family its rwkv6 kind. The port's
        own nemotron_h family counts every parameter, its norms and the
        conv's bias included."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # output head
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        mlp_mats = 3 if self.mlp_act == "swiglu" else 2
        if self.moe is not None:
            e = self.moe
            mlp = e.num_experts * (mlp_mats * d * e.d_ff_expert) + d * e.num_experts
        else:
            mlp = mlp_mats * d * self.d_ff
        if self.family == "nemotron_h":  # one mixer a layer, by the pattern
            s = self.ssm
            d_in = s.expand * d
            heads, conv_ch = d_in // s.head_dim, d_in + 2 * s.n_groups * s.state_dim
            per_kind = {"M": d * (d_in + conv_ch + heads) + (s.conv_dim + 1) * conv_ch
                        + 3 * heads + d_in + d_in * d, "-": mlp, "*": attn}
            return n + d + sum(per_kind[k] + d for k in self.hybrid_pattern[:self.num_layers])
        if self.family == "hybrid":  # mamba2 mixers, one shared attention block
            s = self.ssm
            d_in = s.expand * d
            heads = d_in // s.head_dim
            ssm_p = (d * (2 * d_in + 2 * s.state_dim + heads)  # in_proj (z, x, B, C, dt)
                     + s.conv_dim * (d_in + 2 * s.state_dim)  # depthwise conv
                     + 3 * heads  # A_log, dt_bias, D
                     + d_in  # pre-out norm
                     + d_in * d)  # out_proj
            n += self.num_layers * ssm_p
            if self.attn_every > 0:
                n += attn + mlp
        elif self.family == "ssm":  # rwkv6: time-mix + channel-mix a layer
            s = self.ssm
            heads = d // s.head_dim
            ssm_p = 5 * d * d + d * d + 2 * heads * s.head_dim + 6 * d
            n += self.num_layers * (ssm_p + mlp)
        else:
            n += self.num_layers * (attn + mlp)
        if self.encoder is not None:
            n += self.encoder.num_layers * (4 * d * d + mlp_mats * d * self.d_ff)
            n += self.num_layers * 4 * d * d  # decoder cross-attention
        return n


    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        mlp_mats = 3 if self.mlp_act == "swiglu" else 2
        full_experts = e.num_experts * (mlp_mats * self.d_model * e.d_ff_expert)
        active_experts = e.experts_per_token * (mlp_mats * self.d_model * e.d_ff_expert)
        return self.param_count() - self.num_layers * (full_experts - active_experts)

    def to_json(self) -> str:
        """The reference's ``ModelConfig.to_json``, byte for byte: its fields
        in its order. Every field of the port is one of the reference's; the
        three it does not keep are derived: ``use_pallas`` is False (the
        port picks a kernel by the tensor's device, not by a config flag),
        ``shared_attention`` holds for the hybrid family (zamba2's one
        shared block) and ``ssm.kind`` is "rwkv6" for the ssm family and
        "mamba2" for the hybrid one. The port's own fields (``PORT_ONLY_FIELDS``)
        appear only where they differ from their defaults, which no arch
        of the reference's does."""
        out: Dict[str, Any] = {}
        for k, v in dataclasses.asdict(self).items():
            if k in PORT_ONLY_FIELDS and v == PORT_ONLY_FIELDS[k]:
                continue
            if k == "ssm" and v is not None:
                if v["n_groups"] == PORT_ONLY_FIELDS["n_groups"]:
                    del v["n_groups"]
                v = {"kind": "rwkv6" if self.family == "ssm" else "mamba2", **v}
            out[k] = v
            if k == "attn_chunk":
                out["use_pallas"] = False
            elif k == "attn_every":
                out["shared_attention"] = self.family == "hybrid"
        return json.dumps(out, indent=2, default=str)


# the port's fields that the reference's configs lack, at their defaults
PORT_ONLY_FIELDS = {"hybrid_pattern": "", "norm_eps": None, "n_groups": 1}


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for the sub-quadratic archs."""
    if shape.name == "long_500k" and not model.supports_subquadratic_decode:
        return False
    return True


# ---------------------------------------------------------------------------
# Sharding / deployment profile
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingProfile:
    """How a model is laid out on the mesh.

    Axis names refer to mesh axes ("pod", "data", "model"). ``fsdp_axes``
    shards parameters + optimizer state over those axes (ZeRO-3);
    ``tp_axis`` applies Megatron-pattern tensor parallelism; MoE expert
    weights shard over ``ep_axis`` when the MoE mode is "ep".
    """

    tp_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ()  # e.g. ("data",) or ("pod", "data")
    dp_axes: Tuple[str, ...] = ("data",)  # batch axes (pod is appended when present)
    ep_axis: str = "model"
    pipeline_axis: str = ""  # "" = no pipeline parallelism
    pipeline_stages: int = 1
    remat: str = "none"  # none | full | dots | offload
    optimizer_dtype: str = "float32"  # float32 | bfloat16 (1T-scale models)
    gradient_compression: str = "none"  # none | int8_ef
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8
    # shard long KV caches over the TP axis by sequence when heads < tp size
    shard_kv_seq: bool = False
    # sequence parallelism: shard activations' seq dim over tp_axis
    seq_parallel: bool = False
    # shard K/V projections over tp (off where kv_dim/tp splits within heads)
    shard_kv_proj: bool = True
    # use these mesh axes as ADDITIONAL data-parallel axes (e.g. ("model",)
    # for small models where TP is pure overhead; set tp_axis="" with it)
    extra_dp_axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class DeploymentConfig:
    """Full deployment = model + sharding + runtime knobs."""

    model: ModelConfig
    sharding: ShardingProfile = field(default_factory=ShardingProfile)
    max_decode_steps: int = 64
    microbatch: int = 0  # 0 = no gradient accumulation


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
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, experts_per_token=2,
                                        d_ff_expert=64)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk_size=16)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, num_layers=2, num_frames=16,
                                            frame_dim=128)
    if cfg.attn_every > 1:
        kw["num_layers"] = 4
        kw["attn_every"] = 2
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
