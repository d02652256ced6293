"""granite-moe-1b-a400m: small MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — 24L d_model=1024 16H
(GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""

from repro_torch.configs.base import MoEConfig, ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert FFN width
    vocab_size=49_155,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoEConfig(
        num_experts=32,
        experts_per_token=8,
        d_ff_expert=512,
        capacity_factor=1.25,
        mode="dense",  # small enough for GShard dense dispatch
    ),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=(),
    remat="full",
    # decode KV: kv_heads < TP would split head_dim and psum scores per
    # layer; sequence-sharding the cache is cheaper (the reference's TPU dry run)
    shard_kv_seq=True,
)


# Beyond-paper optimized TRAIN deployment (from the reference's TPU dry run):
# at seq 4k / global batch 256 on a 256-chip pod, per-layer FSDP gathers
# cost far less than Megatron activation all-reduces — every <=15B train
# cell flips to compute-bound there.
SHARDING_TRAIN = ShardingProfile(
    tp_axis="",
    fsdp_axes=("data", "model"),
    extra_dp_axes=("model",),
    remat="full",
)
