"""olmo-1b: dense transformer with non-parametric LayerNorm.

[arXiv:2402.00838; hf] — 16L d_model=2048 16H (GQA kv=16 == MHA) d_ff=8192
vocab=50304, non-parametric LN (no scale/bias).
"""

from repro_torch.configs.base import ModelConfig

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
