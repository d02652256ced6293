"""Trace recording and replayable failure seeds (the twin of
``repro.sim.trace``).

Every applied operation (client ops, control-plane ``keys``/``len``
scans, fault firings — including membership ``join``/``drain`` — async
cachegen worker ops, deferred lag writes) is folded into a running
blake2b hash and kept in an in-memory ring. Two runs of the same
``(seed, config)`` must produce the identical hash — that IS the
determinism contract ``python -m repro_torch.sim --seed N`` verifies. Real
concurrency the sim tolerates stays OUT of the fold: a hedged dispatch
records the winning TIER, never which replica won the race.

On an oracle violation the CLI dumps a **repro file** (see
``repro_torch.sim.__main__._fail_dump``): the full simulation config plus the
violation list and the trace tail carried on the report. The file is
self-contained — ``python -m repro_torch.sim --replay FILE`` reruns the exact
configuration and asserts the trace hash matches the recorded one, so a
red CI seed replays to the identical interleaving on a laptop. A dump of
either package replays in the other: the config has the same fields and
the hash the same events.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, default=repr, separators=(",", ":"))


class TraceRecorder:
    """Order-sensitive event log with a running hash and a bounded tail."""

    def __init__(self, keep_last: int = 400):
        self.keep_last = keep_last
        self.n_events = 0
        self.tail: List[Dict[str, Any]] = []
        self._h = hashlib.blake2b(digest_size=16)

    def record(self, step: int, actor: str, kind: str,
               args: Any = None, result: Any = None) -> None:
        ev = {"step": step, "actor": actor, "kind": kind,
              "args": args, "result": result}
        self._h.update(_canon(ev).encode())
        self.n_events += 1
        self.tail.append(ev)
        if len(self.tail) > self.keep_last:
            del self.tail[: len(self.tail) - self.keep_last]

    @property
    def trace_hash(self) -> str:
        return self._h.hexdigest()

    @staticmethod
    def load_repro(path: str) -> Dict[str, Any]:
        with open(path) as f:
            return json.load(f)


__all__ = ["TraceRecorder"]
