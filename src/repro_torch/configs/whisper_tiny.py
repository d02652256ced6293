"""whisper-tiny: encoder-decoder audio model; conv frontend stubbed.

[arXiv:2212.04356; unverified] — 4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865, enc-dec. The conv1d/mel frontend is a stub: the caller passes
precomputed frame embeddings (1500 frames x 384).
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

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
