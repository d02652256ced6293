"""olmo-1b: dense transformer with non-parametric LayerNorm.

[arXiv:2402.00838; hf] — 16L d_model=2048 16H (GQA kv=16 == MHA) d_ff=8192
vocab=50304, non-parametric LN (no scale/bias).
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    mlp_act="swiglu",
    norm_type="layernorm_np",  # non-parametric: normalize only, no affine
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2402.00838",
)

# Serving profile: TP over model (16 heads divide 16 cleanly; inference
# batches 32/128 cannot shard 256 DP ways).
SHARDING = ShardingProfile(
    tp_axis="model",
    fsdp_axes=(),
    remat="full",
)

# Beyond-paper optimized TRAIN deployment (from the reference's TPU dry run):
# a 1.2B model gains nothing from TP=16 at global batch 256 — use the
# model axis as extra data parallelism + FSDP (the reference's dry run on
# its TPU mesh measured the gain; no port number stands behind it).
SHARDING_TRAIN = ShardingProfile(
    tp_axis="",  # TP disabled; model axis joins DP
    fsdp_axes=("data", "model"),
    extra_dp_axes=("model",),
    remat="full",
)
