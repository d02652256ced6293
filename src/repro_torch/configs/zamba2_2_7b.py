"""zamba2-2.7b: Mamba2 backbone + shared attention blocks (hybrid).

[arXiv:2411.15242; hf] — 54L d_model=2560 32H (GQA kv=32 == MHA) d_ff=10240
vocab=32000, ssm_state=64. A single shared transformer block is applied after
every 6 Mamba2 layers (9 applications over 54 layers), Zamba2-style: shared
*weights*, per-application KV cache slots.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, ShardingProfile

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    attn_every=6,  # shared attention after every 6 mamba2 layers
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
    source="arXiv:2411.15242",
)

SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=("data",),
    remat="full",
    shard_kv_seq=True,  # long_500k: shard the 500k KV slots by sequence
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
