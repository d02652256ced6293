"""nemotron-4-15b: dense GQA transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU (no gate => 2 MLP matrices).
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_act="squared_relu",
    norm_type="layernorm",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
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
