"""Token sampling on the device: greedy / temperature / top-k."""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(
    logits: torch.Tensor,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: int = 0,
) -> torch.Tensor:
    """logits: (B, V) -> (B, 1) int32 on the logits' device.

    Greedy takes the first maximal index (as ``jnp.argmax``). Temperature
    sampling draws from ``generator``: its draws differ from the
    reference's ``jax.random`` key, so only greedy decoding is token-exact
    across the two packages."""
    lg = logits.float()
    if temperature <= 0.0:
        tok = torch.argmax(lg, dim=-1)
    else:
        lg = lg / temperature
        if top_k:
            kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        probs = torch.softmax(lg, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return tok[:, None].to(torch.int32)
