"""kimi-k2-1t-a32b: trillion-parameter MoE (Kimi K2 paper-table config).

[arXiv:2501.kimi2; unverified] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8. ~1T total / ~32B active params.

Mode "ep": expert parallelism over a mesh (``models/moe.py``'s
``moe_forward_ep``); without a mesh the exact grouped (dropless) path, as
the reference runs it. One H100 holds one layer at published width
(about 38.8 GB in bf16), not 61.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,  # per-expert FFN width
    vocab_size=163_840,
    qk_norm=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(
        num_experts=384,
        experts_per_token=8,
        d_ff_expert=2048,
        capacity_factor=1.25,
        mode="ep",
    ),
    source="arXiv:2501.kimi2 (paper-table)",
)

SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=("pod", "data"),
    ep_axis="model",
    remat="full",
    # decode KV: kv_heads < TP would split head_dim and psum scores per
    # layer; sequence-sharding the cache is cheaper (the reference's TPU dry run)
    shard_kv_seq=True,
    # 1T params: fp32 m/v would not fit the reference's 512-chip TPU mesh
    optimizer_dtype="bfloat16",
    gradient_compression="int8_ef",
)
