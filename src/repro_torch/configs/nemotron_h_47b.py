"""nemotron-h-47b: hybrid Mamba-2 / attention decoder (Nemotron-H), cut to
the first 49 of its 98 layers. Port only: the reference has no such arch.

[hf:nvidia/Nemotron-H-47B-Base-8K config.json] — 98L d_model=8192, layer
kinds by ``hybrid_override_pattern``: 45 Mamba-2 (256 heads of 64, state
256, 8 B/C groups, conv 4, expand 2), 48 squared-ReLU MLPs (d_ff 30720), 5
GQA attentions (64/8 heads, head dim 128, no position encoding); RMSNorm at
eps 1e-5 before each mixer and at the end; untied vocabulary 131072.

The 94 GB of bf16 weights need two H100s; this config is the first stage
of a two-stage pipeline, layers 0-48 (24 Mamba-2, 23 MLP and 2 attention
layers, at 17 and 38), plus the head, so that one card yields logits: 24.5B
parameters, 45.7 GiB in bf16. Every width is the published one.
"""

from repro_torch.configs.base import ModelConfig, ShardingProfile, SSMConfig

PATTERN = ("M-M-M-M-M-M-M-M-M*-M-M-M-M-M-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M-M-M"
           "---MM---M-M*-M-M-M-M-M-")

CONFIG = ModelConfig(
    name="nemotron-h-47b",
    family="nemotron_h",
    num_layers=49,  # of 98: the first stage of a two-card pipeline
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=30_720,
    vocab_size=131_072,
    rope_type="none",
    mlp_act="squared_relu",
    norm_type="rmsnorm",
    norm_eps=1e-5,
    hybrid_pattern=PATTERN,
    ssm=SSMConfig(state_dim=256, head_dim=64, expand=2, conv_dim=4, chunk_size=128,
                  n_groups=8),
    source="hf:nvidia/Nemotron-H-47B-Base-8K",
)

# the registry's default profile; the family runs on one device (``lm``
# refuses a mesh for it)
SHARDING = ShardingProfile()
