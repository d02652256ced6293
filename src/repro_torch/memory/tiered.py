"""Tiered plan memory: the cold persistent tier under the hot stores (the
twin of ``repro.memory.tiered``).

When the eviction policy picks a victim, the victim's template (with its
insertion context and key embedding) *spills* to an on-disk segment of a
:class:`~repro_torch.checkpoint.store.CheckpointStore` instead of vanishing,
and a miss in the hot tier consults a compact in-RAM **manifest** (key ->
segment id, ``size_tokens``, reuse score) to *promote* the entry back
through the store's normal ``insert_batch`` path.

* **two-phase spill**: the segment is written (atomically: the store's
  ``COMMITTED`` marker) before the manifest references it. A crash between
  the two phases loses the spilled entries but never leaves the manifest
  pointing at a segment that does not exist.
* **refcounted segment gc**: entries still in the manifest pin their
  segment; only fully unreferenced segments rotate under ``keep_last``.
  ``refcount_gc=False`` is the reference's simulation ablation (age
  rotation deletes live segments).

**Template compaction** bounds the bytes a cold entry costs: past a token
budget, step bodies are truncated and non-skeleton output steps collapse
into one summary step. It is idempotent and never grows ``size_tokens``;
non-template values pass through untouched.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.template import PlanStep, PlanTemplate

# -- template compaction ----------------------------------------------------

_STEP_CHAR_CAP = 160  # per-step body cap (chars) of the truncation pass
_SUMMARY_PREFIX = "[compacted:"


def _truncate_steps(tpl: PlanTemplate) -> PlanTemplate:
    """Pass 1: cap each step body at ``_STEP_CHAR_CAP`` chars (ops, the
    slotted skeleton, are kept verbatim)."""
    steps = [PlanStep(s.kind, s.content[:_STEP_CHAR_CAP], s.op) for s in tpl.steps]
    return PlanTemplate(tpl.keyword, steps, tpl.source_task[:_STEP_CHAR_CAP], tpl.uses)


def _elide_outputs(tpl: PlanTemplate) -> PlanTemplate:
    """Pass 2: collapse the non-skeleton ``output`` steps into one summary
    step; message and answer steps are kept, and an existing summary step
    is not summarized again (idempotence)."""
    kept: List[Optional[PlanStep]] = []
    elided = 0
    summary_at: Optional[int] = None
    for s in tpl.steps:
        if s.kind == "output" and not s.content.startswith(_SUMMARY_PREFIX):
            elided += 1
            if summary_at is None:
                summary_at = len(kept)
                kept.append(None)  # placeholder, patched below
            continue
        kept.append(s)
    if elided == 0:
        return tpl
    kept[summary_at] = PlanStep("output", f"{_SUMMARY_PREFIX} {elided} output step(s) elided]",
                                None)
    return PlanTemplate(tpl.keyword, kept, tpl.source_task, tpl.uses)


def compact_template(value: Any, *, budget_tokens: int = 160) -> Tuple[Any, int]:
    """Compact ``value`` toward ``budget_tokens``; returns ``(value',
    saved_tokens)``. Only a :class:`PlanTemplate` compacts; a pass whose
    result is not strictly smaller is discarded."""
    if not isinstance(value, PlanTemplate):
        return value, 0
    before = value.size_tokens()
    out = value
    for compact_pass in (_truncate_steps, _elide_outputs):
        if out.size_tokens() <= budget_tokens:
            break
        candidate = compact_pass(out)
        if candidate.size_tokens() < out.size_tokens():
            out = candidate
    return out, before - out.size_tokens()


# -- cold-entry serialization ------------------------------------------------
#
# A segment is JSON in a uint8 array leaf of the store's crc-checked shard
# files: templates round-trip through a tagged encoding, plain JSON values
# pass through, embedding vectors travel as float lists.


def _encode_value(v: Any) -> Any:
    if isinstance(v, PlanTemplate):
        return {"__plan_template__": {"keyword": v.keyword,
                                      "steps": [s.to_json() for s in v.steps],
                                      "source_task": v.source_task, "uses": v.uses}}
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__plan_template__" in v:
        d = v["__plan_template__"]
        return PlanTemplate(keyword=d["keyword"],
                            steps=[PlanStep.from_json(s) for s in d["steps"]],
                            source_task=d["source_task"], uses=d["uses"])
    return v


class ColdEntry:
    """One promoted cold-tier record (value + its insertion side-channel)."""

    __slots__ = ("value", "context", "vector")

    def __init__(self, value: Any, context: Optional[str], vector: Optional[Any]):
        self.value = value
        self.context = context
        self.vector = vector


class ColdTier:
    """Manifest + CheckpointStore segments for evicted templates.

    Every public method takes the tier's own lock; the owning ``PlanCache``
    also serializes spill and promote under its store lock.
    """

    def __init__(self, directory: str, *, budget_tokens: int = 160, keep_last: int = 8,
                 refcount_gc: bool = True):
        self.budget_tokens = budget_tokens
        self.refcount_gc = refcount_gc
        self.store = CheckpointStore(directory, keep_last=keep_last,
                                     pin_check=(self._segment_live if refcount_gc else None))
        # the compact in-RAM manifest: key -> {segment, size_tokens, score}
        self.manifest: Dict[str, Dict[str, Any]] = {}
        self._seg_refs: Dict[int, int] = {}  # segment id -> live entries
        self._next_segment = 0
        self._crash_after_segment = 0  # fault arming (count-based)
        self._lock = threading.RLock()
        # resume: segment ids continue after those a previous process left
        # (their entries are unreachable without its manifest; gc reclaims)
        steps = self.store.committed_steps()
        if steps:
            self._next_segment = steps[-1] + 1

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self.manifest)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self.manifest

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self.manifest)

    def _segment_live(self, segment: int) -> bool:
        return self._seg_refs.get(segment, 0) > 0

    def live_segments(self) -> List[int]:
        with self._lock:
            return sorted(s for s, n in self._seg_refs.items() if n > 0)

    def arm_crash_after_segment(self, waves: int) -> None:
        """Fault seam: the next ``waves`` spill waves crash between the
        segment write and the manifest commit (the segment lands, the
        manifest never references it: the entries are lost, gc reclaims
        the orphan)."""
        with self._lock:
            self._crash_after_segment = waves

    # -- spill / fetch / take ------------------------------------------------

    def spill(self, entries: Sequence[Tuple[str, Any, Optional[str], Optional[Any], float]]
              ) -> int:
        """Write one spill wave ``(key, value, context, vector, score)`` as
        one segment, then commit the manifest. Returns the compaction tokens
        saved across the wave. Segment first, manifest second: a crash
        between the two loses the wave but never yields a manifest entry
        without a segment behind it."""
        if not entries:
            return 0
        with self._lock:
            records = []
            saved_total = 0
            for key, value, context, vector, score in entries:
                value, saved = compact_template(value, budget_tokens=self.budget_tokens)
                saved_total += saved
                size_fn = getattr(value, "size_tokens", None)
                records.append({
                    "key": key,
                    "value": _encode_value(value),
                    "context": context,
                    "vector": (None if vector is None
                               else np.asarray(vector, dtype=np.float32).tolist()),
                    "size_tokens": int(size_fn()) if callable(size_fn) else 1,
                    "score": float(score),
                })
            segment = self._next_segment
            self._next_segment += 1
            payload = np.frombuffer(json.dumps(records, sort_keys=True).encode(),
                                    dtype=np.uint8)
            # phase 1: the segment (atomic; its save also gcs unpinned ones)
            self.store.save(segment, {"payload": payload})
            if self._crash_after_segment > 0:
                # the armed crash between segment write and manifest commit
                self._crash_after_segment -= 1
                return saved_total
            # phase 2: the manifest commit makes the wave visible
            for rec in records:
                self._drop_ref(rec["key"])  # an overwrite releases the old segment
                self.manifest[rec["key"]] = {"segment": segment,
                                             "size_tokens": rec["size_tokens"],
                                             "score": rec["score"]}
                self._seg_refs[segment] = self._seg_refs.get(segment, 0) + 1
            return saved_total

    def _drop_ref(self, key: str) -> None:
        meta = self.manifest.pop(key, None)
        if meta is not None:
            seg = meta["segment"]
            self._seg_refs[seg] = self._seg_refs.get(seg, 1) - 1
            if self._seg_refs[seg] <= 0:
                del self._seg_refs[seg]

    def _read_segment(self, segment: int) -> Dict[str, Dict[str, Any]]:
        try:
            tree, _ = self.store.restore({"payload": np.zeros(0, dtype=np.uint8)},
                                         step=segment)
        except (FileNotFoundError, KeyError, IOError):
            return {}
        records = json.loads(bytes(np.asarray(tree["payload"])).decode())
        return {r["key"]: r for r in records}

    def fetch(self, keys: Sequence[str]) -> List[Optional[ColdEntry]]:
        """Resolve ``keys`` against the manifest and load their segments
        (one read per distinct segment). Entries stay cold: :meth:`take`
        promotes."""
        with self._lock:
            out: List[Optional[ColdEntry]] = [None] * len(keys)
            by_segment: Dict[int, List[int]] = {}
            for i, k in enumerate(keys):
                meta = self.manifest.get(k)
                if meta is not None:
                    by_segment.setdefault(meta["segment"], []).append(i)
            for segment, idxs in by_segment.items():
                records = self._read_segment(segment)
                for i in idxs:
                    rec = records.get(keys[i])
                    if rec is None:
                        # the segment is gone or torn: the manifest entry is
                        # stale, so it is dropped and the miss counted once
                        self._drop_ref(keys[i])
                        continue
                    vec = rec["vector"]
                    out[i] = ColdEntry(_decode_value(rec["value"]), rec["context"],
                                       None if vec is None else np.asarray(vec, np.float32))
            return out

    def take(self, keys: Sequence[str]) -> List[Optional[ColdEntry]]:
        """Fetch + remove: the promotion primitive (an entry lives in one
        tier, so promoting moves it out of the manifest and unpins its
        segment)."""
        with self._lock:
            got = self.fetch(keys)
            for k, e in zip(keys, got):
                if e is not None:
                    self._drop_ref(k)
            return got

    # -- maintenance ---------------------------------------------------------

    def purge(self, key: str) -> bool:
        """Drop one cold entry (a removed key must not resurrect on a later
        miss)."""
        with self._lock:
            present = key in self.manifest
            self._drop_ref(key)
            return present

    def clear(self) -> None:
        with self._lock:
            self.manifest.clear()
            self._seg_refs.clear()
            self.store.gc()  # nothing is pinned now; reclaim segments

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self.manifest), "segments": len(self._seg_refs),
                    "size_tokens": sum(m["size_tokens"] for m in self.manifest.values())}


__all__ = ["ColdEntry", "ColdTier", "compact_template"]
