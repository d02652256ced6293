"""whisper-tiny: encoder-decoder audio model; conv frontend stubbed.

[arXiv:2212.04356; unverified] — 4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865, enc-dec. The conv1d/mel frontend is a stub: the caller passes
precomputed frame embeddings (1500 frames x 384).
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    mlp_act="gelu",
    norm_type="layernorm",
    rope_type="none",  # sinusoidal (encoder) + learned (decoder) positions
    encoder=EncoderConfig(num_layers=4, num_frames=1500, frame_dim=384),
    frontend="audio_frames",
    source="arXiv:2212.04356",
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
