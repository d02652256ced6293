"""rwkv6-3b ("Finch"): attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
Head size 64 => 40 heads. Time-mix (wkv6) + channel-mix (squared-relu) blocks
with token shift.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, ShardingProfile

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    attn_every=0,  # attention-free
    rope_type="none",
    mlp_act="squared_relu",  # rwkv channel-mix uses relu^2
    norm_type="layernorm",
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=128),
    source="arXiv:2404.05892",
)

SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=("data",),
    remat="full",
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
