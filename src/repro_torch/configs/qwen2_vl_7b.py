"""qwen2-vl-7b: VLM backbone with M-RoPE (multimodal rotary embedding).

[arXiv:2409.12191; hf] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. The vision frontend (dynamic-resolution patch embedding) is a
stub: the caller passes precomputed patch/token embeddings plus (temporal,
height, width) position ids for M-RoPE.
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    mlp_act="swiglu",
    norm_type="rmsnorm",
    rope_type="mrope",
    rope_theta=1_000_000.0,
    frontend="patch_embed",
    source="arXiv:2409.12191",
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
