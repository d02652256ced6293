"""Span exporters: canonical JSONL and Chrome-trace timelines (the twin of
``repro.obs.exporters``).

Spans are exported as they end (children before parents).

* :class:`JsonlExporter` / :class:`InMemoryExporter` — one canonical JSON
  line per span (``sort_keys``, compact separators), so two deterministic
  runs write the same bytes; ``InMemoryExporter.digest()`` is the blake2b
  of that stream.
* :func:`write_chrome_trace` — the Chrome trace-event format
  (``chrome://tracing`` or Perfetto load it): complete ``"X"`` events with
  microsecond ts/dur, span attributes under ``args``, span events as
  instant ``"i"`` markers.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, IO, List, Union

from repro_torch.obs.spans import Span


def span_line(span_dict: Dict[str, Any]) -> str:
    """Canonical one-line JSON for a span dict (byte-stable)."""
    return json.dumps(span_dict, sort_keys=True, separators=(",", ":"),
                      default=repr)


class InMemoryExporter:
    """Collects finished spans in memory."""

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []

    def export(self, span: Span) -> None:
        self.spans.append(span.to_dict())

    def lines(self) -> List[str]:
        return [span_line(s) for s in self.spans]

    def digest(self) -> str:
        h = hashlib.blake2b(digest_size=16)
        for line in self.lines():
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()


class JsonlExporter:
    """Streams canonical span lines to a path or open file."""

    def __init__(self, path_or_file: Union[str, IO[str]]):
        if isinstance(path_or_file, str):
            self._f: IO[str] = open(path_or_file, "w")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False

    def export(self, span: Span) -> None:
        self._f.write(span_line(span.to_dict()))
        self._f.write("\n")

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()


def chrome_trace(span_dicts: List[Dict[str, Any]],
                 process_name: str = "repro") -> Dict[str, Any]:
    """Chrome trace-event JSON for a list of finished span dicts.

    Seconds -> microseconds; every span becomes one complete ``"X"``
    event, every span event an instant ``"i"`` marker. ``tid`` carries the
    root span id of each tree so one admission wave reads as one track.
    """
    roots: Dict[int, int] = {}
    by_id = {s["span_id"]: s for s in span_dicts}

    def root_of(sid: int) -> int:
        seen = []
        cur = sid
        while cur in by_id and by_id[cur]["parent_id"] is not None \
                and by_id[cur]["parent_id"] in by_id:
            seen.append(cur)
            cur = by_id[cur]["parent_id"]
        for s in seen:
            roots[s] = cur
        return cur

    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": process_name},
    }]
    for s in span_dicts:
        tid = roots.get(s["span_id"]) or root_of(s["span_id"])
        end = s["end"] if s["end"] is not None else s["start"]
        events.append({
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "ts": round(s["start"] * 1e6, 3),
            "dur": round((end - s["start"]) * 1e6, 3),
            "pid": 0,
            "tid": tid,
            "args": dict(s["attrs"], span_id=s["span_id"],
                         parent_id=s["parent_id"]),
        })
        for ev in s["events"]:
            events.append({
                "name": ev["name"],
                "cat": "event",
                "ph": "i",
                "s": "t",
                "ts": round(ev["t"] * 1e6, 3),
                "pid": 0,
                "tid": tid,
                "args": dict(ev["attrs"]),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, span_dicts: List[Dict[str, Any]],
                       process_name: str = "repro") -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(span_dicts, process_name), f,
                  sort_keys=True, separators=(",", ":"), default=repr)
        f.write("\n")


__all__ = [
    "InMemoryExporter",
    "JsonlExporter",
    "chrome_trace",
    "span_line",
    "write_chrome_trace",
]
