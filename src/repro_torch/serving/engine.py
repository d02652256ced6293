"""Serving engine: prefill + decode for one model deployment (the port of
``repro.serving.engine``, without the paged KV prefix path).

One Engine instance = one model (a planner tier or the actor). It exposes

  * ``generate(tokens, max_new)`` — batched greedy/temperature generation
  * ``measured_rates()`` — tokens/s observed on the device, fed to the APC
    cost model so control-plane latency comes from the data plane.

The engine runs on ``cuda`` unless constructed with ``device="cpu"``.
Its timers synchronize the device before reading the clock, so the rates
measure device work, not kernel-launch time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.serving.sampler import sample_token


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    def rates(self) -> Dict[str, float]:
        return {
            "prefill": self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0,
            "decode": self.decode_tokens / self.decode_s if self.decode_s else 0.0,
        }


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, *, max_len: int = 512,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = lm.params_to(params, self.device)
        self.max_len = max_len
        self.stats = EngineStats()

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def prefill(self, tokens: np.ndarray, *,
                n_valid: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """tokens: (B, S) int -> (last logits (B, V) on the device, cache).

        ``n_valid`` is the number of REAL tokens in the batch; without it
        every element counts, padding included."""
        t0 = self._clock()
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits, cache = lm.prefill(self.cfg, self.params, toks, cache_len=self.max_len)
        logits = logits[:, -1]
        self.stats.prefill_s += self._clock() - t0
        self.stats.prefill_tokens += int(tokens.size if n_valid is None else n_valid)
        return logits, cache

    def decode(self, cache: Any, tokens: np.ndarray, *,
               active: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """One decode step (updates ``cache`` in place). ``active`` counts
        the rows still generating; finished (post-EOS) rows ride along in
        the dense batch but must not inflate the decode tokens/s rate."""
        t0 = self._clock()
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits, cache = lm.decode_step(self.cfg, self.params, cache, toks)
        logits = logits[:, -1]
        self.stats.decode_s += self._clock() - t0
        self.stats.decode_tokens += int(tokens.shape[0] if active is None else active)
        return logits, cache

    def generate(
        self,
        tokens: np.ndarray,
        max_new: int = 32,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        prompt_lengths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Batched generation. Returns (B, <=max_new) generated ids.

        Rows that hit ``eos_id`` emit ``pad_id`` from the next step on and
        stop counting toward decode throughput. ``prompt_lengths`` ((B,)
        valid prompt token counts) keeps right-padding out of the prefill
        rate."""
        B, S = tokens.shape
        if S + max_new > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new ({max_new}) exceeds the engine's "
                f"KV capacity (max_len={self.max_len}); decode would write "
                f"past the cache"
            )
        n_valid = None if prompt_lengths is None else int(np.sum(prompt_lengths))
        logits, cache = self.prefill(tokens, n_valid=n_valid)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = sample_token(logits, temperature, gen).cpu().numpy()
        done = np.zeros((B,), bool)
        for i in range(max_new):
            if eos_id is not None and done.any():
                # finished rows keep a slot in the dense batch but must
                # emit padding, not whatever the sampler drew for them
                tok = np.where(done[:, None], pad_id, tok).astype(tok.dtype)
            out.append(tok)
            if eos_id is not None:
                done |= tok[:, 0] == eos_id
                if done.all():
                    break
            if i + 1 == max_new:
                break  # the last token is emitted; skip the wasted decode
            logits, cache = self.decode(cache, tok, active=int(B - done.sum()))
            tok = sample_token(logits, temperature, gen).cpu().numpy()
        return np.concatenate(out, axis=1)

    def measured_rates(self) -> Dict[str, float]:
        r = self.stats.rates()
        r["rtt"] = 0.0  # local serving: no API round-trip
        return r
