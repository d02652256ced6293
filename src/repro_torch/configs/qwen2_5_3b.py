"""qwen2.5-3b: dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, GQA, QKV bias.
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
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
