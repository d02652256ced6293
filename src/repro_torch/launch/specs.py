"""Input stand-ins for every (arch x shape) cell (the port of
``repro.launch.specs``): meta tensors, no storage.

The modality frontends are stubs: VLM cells get precomputed patch/token
embeddings + M-RoPE position ids; audio cells get precomputed frame
embeddings. ``concrete_batch`` draws a batch of those shapes (smoke scale
only).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm

DECODE_HEADROOM = 16  # extra KV slots beyond the prefilled seq_len (TP-aligned)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Dict[str, Any], Optional[Any]]:
    """Returns (batch of meta tensors, meta cache or None)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    if shape.kind == "decode":
        batch = {"tokens": _meta((B, 1), i32)}
        cache = lm.abstract_cache(cfg, B, S + DECODE_HEADROOM)
        return batch, cache

    if cfg.family == "vlm":
        batch: Dict[str, Any] = {
            "embeds": _meta((B, S, cfg.d_model), act),
            "positions": _meta((3, B, S), i32),
        }
    elif cfg.family == "audio":
        batch = {
            "frames": _meta((B, cfg.encoder.num_frames, cfg.d_model), act),
            "tokens": _meta((B, S), i32),
        }
    else:
        batch = {"tokens": _meta((B, S), i32)}

    if shape.kind == "train":
        batch["labels"] = _meta((B, S), i32)
    return batch, None


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                   generator: Optional[torch.Generator] = None, device="cpu"):
    """A random batch matching ``input_specs`` (smoke scale only): ids in
    [0, max(2, vocab - 1)), activations N(0, 1); the cache stays abstract."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    specs, cache = input_specs(cfg, shape)

    def mk(s):
        if s.dtype == torch.int32:
            return torch.randint(0, max(2, cfg.vocab_size - 1), tuple(s.shape), generator=gen,
                                 dtype=torch.int32).to(device)
        return torch.randn(tuple(s.shape), generator=gen).to(s.dtype).to(device)

    return {name: mk(s) for name, s in specs.items()}, cache
