"""Bounded structured event log (port of ``kubetpu/obs/events.py``).

A bounded ring of events

    {"ts": <epoch seconds>, "seq": <per-log monotonic int>,
     "kind": "admit" | "retire" | "prefix_hit" | "migrate_in" | ...,
     "component": "serving" | "replica:<name>" | None,
     "trace_id": <32-hex or absent>, ...free-form flat fields...}

recorded by the serving lifecycle (admission, retire, queue expiry,
cancel, migration), the paged server's prefix cache (hit, publish, evict,
spill, fill) and the replica's wire legs. Bounded (a deque ring with a
``dropped`` counter), cheap (one lock, one dict append: never a device
sync), and trace-linked: ``emit`` reads ``obs.trace.current_trace_id()``,
so an event emitted under a wire request carries that request's trace id.
``merge_events`` joins several logs for ``GET /events``;
``validate_events_jsonl`` checks that stream. ``set_sink(path)`` tees every
event to a JSONL file; the process-default log (``event_log()``) honours
``KUBETPU_EVENT_SINK`` at import.

Stdlib only; imports nothing from the port outside ``obs``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from kubetpu_torch.obs import trace as obs_trace

# keys every event carries (the JSONL schema validate_events_jsonl pins)
REQUIRED_KEYS = ("ts", "seq", "kind")


class EventLog:
    """Bounded ring of structured events + optional JSONL sink."""

    def __init__(self, capacity: int = 4096,
                 component: Optional[str] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lock = threading.Lock()
        self._sink_lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0
        self.component = component
        self._sink = None
        self._sink_path: Optional[str] = None

    def emit(self, kind: str, component: Optional[str] = None,
             **fields) -> dict:
        """Record one event; free-form *fields* ride flat in the dict
        (values must be JSON-serializable — coerced to ``str`` when not).
        The current trace id (if a span is active) is captured so the
        event cross-links to its trace. Returns the event."""
        ev: Dict[str, object] = {
            "ts": time.time(),
            "kind": str(kind),
        }
        comp = component or self.component
        if comp:
            ev["component"] = comp
        tid = obs_trace.current_trace_id()
        if tid:
            ev["trace_id"] = tid
        for k, v in fields.items():
            ev[k] = v if isinstance(
                v, (str, int, float, bool, type(None))) else str(v)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
            sink = self._sink
        if sink is not None:
            line = json.dumps(ev) + "\n"
            with self._sink_lock:
                if self._sink is not sink:   # closed/replaced concurrently
                    return ev
                try:
                    sink.write(line)
                    sink.flush()
                except OSError:
                    # a full/unwritable sink must never take the workload
                    # down; the ring keeps recording
                    self._sink = None
                    self._sink_path = None
                    try:
                        sink.close()
                    except OSError:
                        pass
        return ev

    def events(self, kind: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Events oldest-first, optionally filtered by *kind* and
        truncated to the LAST *limit*."""
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit else []   # [-0:] is everything
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def counts(self) -> Dict[str, int]:
        """{kind: occurrences in the ring}."""
        out: Dict[str, int] = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def to_jsonl(self, kind: Optional[str] = None,
                 limit: Optional[int] = None) -> str:
        """The ring as JSON Lines."""
        evs = self.events(kind=kind, limit=limit)
        return "".join(json.dumps(e) + "\n" for e in evs)

    def set_sink(self, path: Optional[str]) -> None:
        """Tee every future event to *path* (append); None closes."""
        new_sink = open(path, "a", encoding="utf-8") if path else None
        with self._sink_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
            self._sink_path = path
            self._sink = new_sink

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


def merge_events(logs: Dict[str, EventLog],
                 limit: Optional[int] = None) -> List[dict]:
    """Merge several components' rings into one (ts, seq)-ordered list,
    stamping each event's ``component`` when the log didn't."""
    out: List[dict] = []
    for name, log in sorted(logs.items()):
        for e in log.events():
            if "component" not in e:
                e = dict(e, component=name)
            out.append(e)
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    if limit is not None and limit >= 0:
        out = out[-limit:] if limit else []
    return out


def validate_events_jsonl(text: str) -> List[str]:
    """Problems found in *text* as an event JSONL stream (empty = valid):
    non-JSON lines, non-object lines, missing/ill-typed required keys.
    The ``make obs-check`` oracle for ``GET /events``."""
    problems: List[str] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if not raw.strip():
            continue
        try:
            ev = json.loads(raw)
        except ValueError:
            problems.append(f"line {lineno}: not JSON: {raw[:80]!r}")
            continue
        if not isinstance(ev, dict):
            problems.append(f"line {lineno}: not an object")
            continue
        for key in REQUIRED_KEYS:
            if key not in ev:
                problems.append(f"line {lineno}: missing {key!r}")
        if "ts" in ev and not isinstance(ev["ts"], (int, float)):
            problems.append(f"line {lineno}: ts is not a number")
        if "seq" in ev and not isinstance(ev["seq"], int):
            problems.append(f"line {lineno}: seq is not an int")
        if "kind" in ev and not isinstance(ev["kind"], str):
            problems.append(f"line {lineno}: kind is not a string")
    return problems


# -- process-default log ------------------------------------------------------

_DEFAULT = EventLog()
if os.environ.get("KUBETPU_EVENT_SINK"):
    try:
        _DEFAULT.set_sink(os.environ["KUBETPU_EVENT_SINK"])
    except OSError:
        pass


def event_log() -> EventLog:
    """The process-wide event log — where code without a component-scoped
    log (checkpoint save/restore, CLIs) records. Servers create their OWN
    logs, like registries: in-process test fleets must not interleave."""
    return _DEFAULT
