"""Lightweight distributed tracing for the kubetpu wire + workload stack
(a copy of ``kubetpu/obs/trace.py``: the same headers, so a port replica's
spans stitch into a trace that a ``kubetpu`` router or client started).

One ``span()`` context manager produces structured events — trace_id /
span_id / parent, op, component, start (epoch seconds), dur, tags —
recorded into a bounded process-wide ``Tracer`` ring (optionally teed to a
JSONL sink for offline inspection). Context rides a ``contextvars``
ContextVar, so nested spans parent correctly per thread, and crosses the
process boundary as two HTTP headers:

    X-Kubetpu-Trace-Id:    32-hex trace id
    X-Kubetpu-Parent-Span: 16-hex span id of the caller's span

``httpcommon.request_json`` injects them per attempt (so a retry's child
span becomes the server span's parent — retries are VISIBLE in the
stitched trace), and ``handle_guarded`` extracts them before routing, so
one ``gang_launch`` or pod submit yields a single trace spanning
controller -> agent -> allocate.

Sampling: everything is recorded; the ring bounds memory (dropped-oldest,
``dropped`` counter keeps the loss honest). The hot wire paths produce a
handful of spans per request — cheap next to one HTTP exchange. Code that
would span per (pod x node) in the scheduler predicate loop must NOT: the
discipline is spans at operation granularity (schedule, allocate, probe),
histograms at loop granularity.

Env: ``KUBETPU_TRACE_SINK=/path/f.jsonl`` opens the sink at import.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

TRACE_HEADER = "X-Kubetpu-Trace-Id"
PARENT_HEADER = "X-Kubetpu-Parent-Span"

# (trace_id, span_id) of the currently-executing span in this context
_ctx: contextvars.ContextVar[Optional[Tuple[str, str]]] = contextvars.ContextVar(
    "kubetpu_trace_ctx", default=None
)


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One in-flight span; finished spans are stored as plain dicts."""

    __slots__ = ("trace_id", "span_id", "parent_id", "op", "component",
                 "start", "tags", "status", "_t0")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 op: str, component: Optional[str], tags: Dict) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.op = op
        self.component = component
        self.start = time.time()
        self.tags = dict(tags)
        self.status = "ok"
        self._t0 = time.perf_counter()

    def tag(self, **kv) -> "Span":
        self.tags.update(kv)
        return self

    def _finish(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "op": self.op,
            "start": self.start,
            "dur": time.perf_counter() - self._t0,
            "status": self.status,
        }
        if self.component:
            out["component"] = self.component
        if self.tags:
            # tags must be JSON-serializable for the sink; coerce defensively
            out["tags"] = {k: v if isinstance(v, (str, int, float, bool,
                                                  type(None))) else str(v)
                           for k, v in self.tags.items()}
        return out


class Tracer:
    """Bounded ring of finished spans + optional JSONL sink.

    The process-wide instance (``tracer()``) is what the wire servers
    serve at ``GET /trace/<id>``; tests may instantiate their own and pass
    it to ``span(tracer_=...)`` for isolation."""

    def __init__(self, capacity: int = 8192) -> None:
        self._lock = threading.Lock()
        # the sink has its OWN lock: disk I/O must never hold up the ring
        # (every request thread records spans; only the sink writer pays
        # the filesystem)
        self._sink_lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._sink_path: Optional[str] = None
        self._sink = None

    def record(self, span_dict: dict) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span_dict)
            sink = self._sink
        if sink is not None:
            line = json.dumps(span_dict) + "\n"
            with self._sink_lock:
                if self._sink is not sink:  # closed/replaced concurrently
                    return
                try:
                    sink.write(line)
                    sink.flush()
                except OSError:
                    # a full/unwritable sink must never take the workload
                    # down; the ring keeps recording
                    self._sink = None

    def spans(self, trace_id: Optional[str] = None) -> List[dict]:
        """Finished spans (oldest first), optionally for one trace."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out

    def set_sink(self, path: Optional[str]) -> None:
        """Tee every finished span to *path* as one JSON line (append);
        None closes the sink."""
        new_sink = open(path, "a", encoding="utf-8") if path else None
        with self._sink_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
            self._sink_path = path
            self._sink = new_sink  # attribute swap is atomic under the GIL

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


_TRACER = Tracer()
if os.environ.get("KUBETPU_TRACE_SINK"):
    try:
        _TRACER.set_sink(os.environ["KUBETPU_TRACE_SINK"])
    except OSError:
        pass


def tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


# -- context accessors --------------------------------------------------------


def current_trace_id() -> Optional[str]:
    cur = _ctx.get()
    return cur[0] if cur else None


def current_span_id() -> Optional[str]:
    cur = _ctx.get()
    return cur[1] if cur else None


def wire_headers() -> Dict[str, str]:
    """Headers that carry the CURRENT span context to a server; empty when
    no span is active (the callee then starts its own trace)."""
    cur = _ctx.get()
    if cur is None:
        return {}
    out = {TRACE_HEADER: cur[0]}
    if cur[1]:
        out[PARENT_HEADER] = cur[1]
    return out


@contextlib.contextmanager
def attach_wire_context(headers):
    """Adopt an INCOMING request's trace context (server side) for the
    duration: spans opened inside parent under the remote caller's span.
    *headers* is any mapping with ``.get`` (http.server's message object).
    No-op when the request carries no trace headers."""
    tid = headers.get(TRACE_HEADER) if headers is not None else None
    if not tid:
        yield
        return
    # a missing parent header still adopts the trace id: spans become
    # additional ROOTS of the same trace rather than children of a
    # phantom span id
    parent = headers.get(PARENT_HEADER) or None
    token = _ctx.set((tid, parent))
    try:
        yield
    finally:
        _ctx.reset(token)


@contextlib.contextmanager
def span(op: str, component: Optional[str] = None,
         tracer_: Optional[Tracer] = None, **tags):
    """Open a span: child of the current context's span, or a fresh trace
    root when none is active. Yields the ``Span`` (mutate via ``.tag()``);
    an exception marks ``status="error"`` with the message tagged, records
    the span, and re-raises."""
    parent = _ctx.get()
    if parent is None:
        trace_id, parent_id = _new_trace_id(), None
    else:
        trace_id, parent_id = parent
    sp = Span(trace_id, _new_span_id(), parent_id, op, component, tags)
    token = _ctx.set((trace_id, sp.span_id))
    try:
        yield sp
    except BaseException as e:
        sp.status = "error"
        sp.tags.setdefault("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        _ctx.reset(token)
        (tracer_ or _TRACER).record(sp._finish())
