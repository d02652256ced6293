"""qwen3-4b: dense GQA transformer with qk-norm.

[hf:Qwen/Qwen3-8B; hf] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, GQA. head_dim=128 (Qwen3 uses 128 regardless of
d_model/num_heads).
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=("data",),
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
