"""The one traffic generator: a closed loop of ``concurrency`` agent
sessions, served in waves.

A traffic file (``perfbench/traffic/<name>.json``) gives:

* ``concurrency``: sessions, the rows of one ``generate`` call (a wave);
* ``prefix_tokens``: a shared system prompt, the same ids in every call
  (0 for none);
* ``suffix_tokens``: [lo, hi], the per-call tokens after it, one length a
  wave (the engine decodes all rows of a call at one shared position);
* ``lengths_per_block``: the suffix lengths are this many values spread
  evenly over [lo, hi]; each block of that many waves serves every one of
  them once, in an order drawn from the seed, so every seed serves the
  same sizes in another order;
* ``max_new``: greedy tokens a call;
* ``check_rows``: calls of the window the output check compares.

Ids are drawn uniformly from the vocabulary from ``seed``; there is no
tokenizer. The same seed gives the same waves.
"""

from __future__ import annotations

import numpy as np

KEYS = ("concurrency", "prefix_tokens", "suffix_tokens", "lengths_per_block", "max_new",
        "check_rows")


def check_params(p: dict) -> None:
    missing = [k for k in KEYS if k not in p]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    lo, hi = p["suffix_tokens"]
    if not (1 <= lo <= hi and p["concurrency"] >= 1 and p["max_new"] >= 1
            and p["lengths_per_block"] >= 1 and p["prefix_tokens"] >= 0
            and 1 <= p["check_rows"]):
        raise ValueError(f"traffic parameters out of range: {p}")


class Traffic:
    def __init__(self, params: dict, vocab: int, seed: int):
        check_params(params)
        self.p = params
        self.vocab = vocab
        self.seed = seed
        lo, hi = params["suffix_tokens"]
        n = params["lengths_per_block"]
        self.lengths = sorted({int(round(lo + i * (hi - lo) / max(n - 1, 1))) for i in range(n)})
        self.prefix = self._rng("prefix").integers(0, vocab, params["prefix_tokens"],
                                                   dtype=np.int32)

    @property
    def concurrency(self) -> int:
        return self.p["concurrency"]

    @property
    def max_new(self) -> int:
        return self.p["max_new"]

    @property
    def longest_prompt(self) -> int:
        return self.p["prefix_tokens"] + self.p["suffix_tokens"][1]

    @property
    def max_len(self) -> int:
        """The KV capacity a call needs: the longest prompt and its tokens."""
        return self.longest_prompt + self.max_new

    def _rng(self, *stream) -> np.random.Generator:
        tags = [{"prefix": 1, "order": 2, "wave": 3, "warm": 4, "sample": 5}[stream[0]],
                *stream[1:]]
        return np.random.default_rng([self.seed, *tags])

    def suffix_len(self, wave: int) -> int:
        block, i = divmod(wave, len(self.lengths))
        order = self._rng("order", block).permutation(len(self.lengths))
        return self.lengths[order[i]]

    def prompts(self, wave: int) -> np.ndarray:
        """The (concurrency, prompt length) int32 ids of wave ``wave``."""
        return self._prompts(self._rng("wave", wave), self.suffix_len(wave))

    def warm_prompts(self, n_suffix: int) -> np.ndarray:
        """A wave of ``n_suffix`` per-call tokens, from a stream the window
        never draws: set-up warms shapes without serving the window's calls."""
        return self._prompts(self._rng("warm", n_suffix), n_suffix)

    def _prompts(self, rng: np.random.Generator, n_suffix: int) -> np.ndarray:
        c = self.concurrency
        suffix = rng.integers(0, self.vocab, (c, n_suffix), dtype=np.int32)
        prefix = np.broadcast_to(self.prefix, (c, self.prefix.size))
        return np.ascontiguousarray(np.concatenate([prefix, suffix], axis=1))

    def sample(self, prompt_lens) -> list:
        """The calls the output check compares, as (wave, row): the call with
        the longest prompt (the first such), then others drawn from the seed
        without repeats. ``prompt_lens[w]`` is wave w's prompt length."""
        c = self.concurrency
        total = len(prompt_lens) * c
        k = min(self.p["check_rows"], total)
        longest = int(np.argmax(prompt_lens))
        picked = [longest * c]
        rest = self._rng("sample").permutation(total)
        picked += [int(i) for i in rest if int(i) != longest * c][:k - 1]
        return [divmod(i, c) for i in picked]
