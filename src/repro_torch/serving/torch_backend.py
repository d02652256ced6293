"""TorchBackend: the APC control plane driving the port's torch engines
(the twin of ``repro.serving.jax_backend.JaxBackend``).

Semantics (which plan/keyword/answer is produced) come from the simulated
behavioral layer — random-weight models emit no usable text — while every
control-plane LM call is *executed* on the data plane with a token count
matching the call (prefill of the prompt tokens, then up to
``max_exec_tokens`` decode tokens). Real compute, synthetic content.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.backends import SimulatedBackend
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.envs.base import Task
from repro_torch.serving.engine import Engine


class TorchBackend(SimulatedBackend):
    """SimulatedBackend + real data-plane execution per role."""

    def __init__(self, engines: Dict[str, Engine], *, max_exec_tokens: int = 32, **kw):
        super().__init__(**kw)
        self.engines = engines
        self.tok = HashTokenizer()
        self.max_exec = max_exec_tokens

    def _exec(self, role: str, prompt_text: str, out_tokens: int) -> None:
        eng = self.engines.get(role)
        if eng is None:
            return
        ids = self.tok.encode(prompt_text)[: eng.max_len - self.max_exec - 8]
        if not ids:
            ids = [1]
        arr = np.asarray([ids], np.int32)
        eng.generate(arr, max_new=min(out_tokens, self.max_exec))

    # -- overridden role calls (same returns, + real execution) ----------

    def extract_keyword(self, task: Task):
        kw, i, o = super().extract_keyword(task)
        self._exec("keyword_extractor", task.query, o)
        return kw, i, o

    def plan(self, task: Task, responses, *, large: bool, round_idx: int):
        msg, i, o = super().plan(task, responses, large=large, round_idx=round_idx)
        role = "large_planner" if large else "small_planner"
        self._exec(role, task.query + " " + str(responses)[-512:], o)
        return msg, i, o

    def adapt(self, task: Task, template, responses, *, round_idx: int,
              full_history: bool = False):
        msg, i, o = super().adapt(
            task, template, responses, round_idx=round_idx, full_history=full_history
        )
        self._exec("small_planner", task.query, o)
        return msg, i, o

    def act(self, task: Task, plan):
        resp, i, o = super().act(task, plan)
        self._exec("actor", plan.text, o)
        return resp, i, o

    def measured_rates(self) -> Dict[str, Dict[str, float]]:
        return {
            role: eng.measured_rates() for role, eng in self.engines.items()
        }
