"""nemotron-4-15b: dense GQA transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU (no gate => 2 MLP matrices).
"""

from repro_torch.configs.base import ModelConfig

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
