"""Shared HTTP plumbing for the wire stack (a copy of
``kubetpu/wire/httpcommon.py``; the port's replica serves and calls
through it).

Server side (agent + controller): JSON / text replies and the bearer-token
check. One implementation so security hardening (constant-time compare,
latin-1 header handling) can never drift between the two surfaces.

Client side: ``request_json`` / ``request_text`` — THE one urllib call
every wire client routes through (``RemoteDevice``, ``gang_launch``,
``schedsim``, the controller's federation scrapes, the obs CLI), carrying
the chaos-hardening contract in one place (lint rule KTP002 statically
rejects raw ``urlopen`` anywhere else):

- jittered exponential retry with a per-call wall-clock deadline
  (``RetryPolicy``): transient connection failures, timeouts, truncated
  responses and infra-transient 502/503/504 answers are retried;
  application errors (4xx, and plain 500 — deterministic, re-executing
  just repeats it) are surfaced immediately;
- retry SAFETY: GET/DELETE are retried freely (idempotent by contract);
  a POST is retried ONLY when the caller attaches an idempotency key —
  a retried non-keyed POST could double-allocate, so it gets exactly one
  attempt. Keys travel as the ``Idempotency-Key`` header and are deduped
  server-side (``IdempotencyCache``);
- fault injection: an injector installed per-call (``faults=``) or
  process-wide (``faults.install_client``) may drop/delay outbound calls.

``IdempotencyCache`` is the server half of the key contract: a bounded
replay window mapping key -> committed 200 response. Only SUCCESS is
cached — a failed attempt clears the in-flight marker so the retry may
re-execute (at-most-once success, at-least-once attempt).

Observability (Round-8, ``kubetpu_torch.obs``): every ``request_json`` call runs
inside a client trace span with retries as child spans, propagating the
trace context via ``X-Kubetpu-Trace-Id`` / ``X-Kubetpu-Parent-Span``;
``handle_guarded`` adopts it server-side, so controller -> agent chains
stitch into one trace. Client-side wire counters
(``kubetpu_wire_requests_total`` / ``_retried_total``) land on the
process-default ``obs.Registry``.
"""

from __future__ import annotations

import contextlib
import hmac
import http.client
import io
import json
import random as _random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

from kubetpu_torch.obs import registry as obs_registry
from kubetpu_torch.obs import trace as obs_trace

# -- server reply helpers ----------------------------------------------------


def write_json(handler, code: int, obj) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    _write_body(handler, body)


def write_text(handler, code: int, text: str,
               content_type: str = "text/plain; version=0.0.4") -> None:
    body = text.encode()
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    _write_body(handler, body)


def serve_events_jsonl(handler, render) -> None:
    """The shared ``GET /events`` plumbing (agent, controller and the
    obs exporter all serve the same surface): parse ``?kind=``/
    ``?limit=`` from the handler's path, 400 a non-integer limit, and
    write *render*(kind=, limit=) as NDJSON."""
    import urllib.parse

    url = urllib.parse.urlsplit(handler.path)
    q = urllib.parse.parse_qs(url.query)
    try:
        limit = int(q["limit"][0]) if "limit" in q else None
    except ValueError:
        write_json(handler, 400, {"error": "limit must be an integer"})
        return
    write_text(handler, 200,
               render(kind=(q.get("kind") or [None])[0], limit=limit),
               content_type="application/x-ndjson")


def _write_body(handler, body: bytes) -> None:
    """Body write with the partial-response fault hook: when the fault
    layer marked this request (``_fault_truncate``), advertise the full
    Content-Length but write only half the body and close — the client's
    read raises ``IncompleteRead``, manufacturing the processed-but-
    response-lost window idempotency keys exist for."""
    if getattr(handler, "_fault_truncate", False):
        # consume the mark either way: it must never leak into a later
        # keep-alive request served by the same handler instance
        handler._fault_truncate = False
        if len(body) > 1:
            handler.wfile.write(body[: len(body) // 2])
            handler.close_connection = True
            return
    handler.wfile.write(body)


def check_bearer(headers, token: Optional[str]) -> bool:
    """True when the request may proceed. Constant-time compare — plain ==
    short-circuits at the first differing byte, leaking the secret through
    timing. Compares BYTES: hmac.compare_digest raises TypeError on
    non-ASCII str (http.server hands headers latin-1-decoded), which would
    drop the connection instead of letting the caller reply 401."""
    if token is None:
        return True
    got = headers.get("Authorization", "")
    return hmac.compare_digest(
        got.encode("latin-1", "replace"),
        f"Bearer {token}".encode("latin-1", "replace"),
    )


# -- retrying client ---------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with a retry budget and a per-call
    deadline. ``attempts`` bounds tries; ``deadline`` bounds wall clock
    (whichever is hit first wins — a slow-timeout route must not multiply
    into attempts x timeout)."""

    attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of each backoff randomized away
    deadline: float = 30.0       # total wall-clock budget, seconds
    # retry 502/503/504 (infra-transient: injected faults, draining
    # servers, in-flight idempotency dups). A plain 500 is an APPLICATION
    # error — deterministic, so re-executing it just repeats the failure
    # (and its side effects) and delays the surfaced error by the budget.
    retry_5xx: bool = True


DEFAULT_RETRY = RetryPolicy()
NO_RETRY = RetryPolicy(attempts=1)

# transient transport failures worth another attempt;
# http.client.HTTPException covers IncompleteRead (truncated response) and
# BadStatusLine/RemoteDisconnected (connection died mid-exchange)
TRANSIENT_ERRORS = (
    urllib.error.URLError,
    ConnectionError,
    TimeoutError,
    OSError,
    http.client.HTTPException,
)


def request_json(
    url: str,
    payload: Optional[dict] = None,
    *,
    method: Optional[str] = None,
    token: Optional[str] = None,
    timeout: float = 5.0,
    retry: Optional[RetryPolicy] = None,
    idempotency_key: Optional[str] = None,
    headers: Optional[dict] = None,
    faults=None,
) -> dict:
    """One JSON request/response over urllib with the shared retry
    discipline. *method* defaults to GET without a payload, POST with one.
    Raises ``urllib.error.HTTPError`` for a final HTTP error status and
    the last transport exception when every attempt failed.

    Observability (Round-8): the logical call runs inside one trace span
    (child of whatever span the caller holds — a fresh trace root
    otherwise), each retry is a CHILD span tagged with its attempt number,
    and the trace context travels to the server as the
    ``X-Kubetpu-Trace-Id`` / ``X-Kubetpu-Parent-Span`` headers — rebuilt
    per attempt, so a server span parents under the exact attempt that
    reached it. ``kubetpu_wire_requests_total`` / ``_retried_total``
    count on the process-default registry."""
    body = _request_raw(
        url, payload=payload, method=method, token=token, timeout=timeout,
        retry=retry, idempotency_key=idempotency_key, headers=headers,
        faults=faults,
    )
    return json.loads(body)


def request_text(
    url: str,
    *,
    token: Optional[str] = None,
    timeout: float = 5.0,
    retry: Optional[RetryPolicy] = None,
    headers: Optional[dict] = None,
    faults=None,
) -> str:
    """One text GET through the SAME retry/trace/fault machinery as
    ``request_json`` — for the non-JSON wire surfaces (Prometheus
    ``/metrics`` federation scrapes, ``/events`` NDJSON). Before
    Round-12 these were raw ``urlopen`` calls, invisible to fault
    injection and trace stitching; now a scrape rides the one client
    (lint rule KTP002 keeps it that way). Pass ``retry=NO_RETRY`` when
    a miss should stay a gap in a graph instead of a backoff."""
    return _request_raw(
        url, payload=None, method="GET", token=token, timeout=timeout,
        retry=retry, idempotency_key=None, headers=headers, faults=faults,
    ).decode()


def _request_raw(
    url: str,
    payload: Optional[dict],
    *,
    method: Optional[str],
    token: Optional[str],
    timeout: float,
    retry: Optional[RetryPolicy],
    idempotency_key: Optional[str],
    headers: Optional[dict],
    faults,
) -> bytes:
    """The shared client workhorse: retry loop, idempotency gating,
    trace spans + header propagation, fault injection, wire counters.
    Returns the response body bytes; the public wrappers decide how to
    decode them."""
    from kubetpu_torch.wire import faults as faults_mod

    reg = obs_registry.default_registry()
    retry = retry or DEFAULT_RETRY
    method = method or ("GET" if payload is None else "POST")
    data = None if payload is None else json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    if token:
        hdrs["Authorization"] = f"Bearer {token}"
    if idempotency_key:
        hdrs["Idempotency-Key"] = idempotency_key
    if headers:
        hdrs.update(headers)
    # retry safety: GET/DELETE are idempotent by wire contract; a POST is
    # only retried under an idempotency key (the server dedups replays)
    retriable = method in ("GET", "HEAD", "DELETE") or bool(idempotency_key)
    attempts = retry.attempts if retriable else 1
    deadline = time.monotonic() + retry.deadline
    delay = retry.base_delay
    # route policies are registered by PATH prefix ("/allocate"), matching
    # the server side — hand the injector the path, not the full URL
    fault_path = urllib.parse.urlsplit(url).path or "/"
    last_exc: Optional[BaseException] = None
    reg.counter("kubetpu_wire_requests_total").inc()
    with obs_trace.span(f"http.{method}", component="wire-client",
                        path=fault_path):
        for attempt in range(attempts):
            injector = (faults if faults is not None
                        else faults_mod.client_injector())
            if attempt:
                reg.counter("kubetpu_wire_requests_retried_total").inc()
                attempt_cm = obs_trace.span(
                    "http.retry", component="wire-client",
                    path=fault_path, attempt=attempt)
            else:
                attempt_cm = contextlib.nullcontext()
            try:
                with attempt_cm:
                    if injector is not None:
                        injector.client_fault(fault_path)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    # context rebuilt per attempt: inside a retry span the
                    # propagated parent IS that retry span
                    attempt_hdrs = dict(hdrs)
                    attempt_hdrs.update(obs_trace.wire_headers())
                    req = urllib.request.Request(
                        url, data=data, headers=attempt_hdrs, method=method
                    )
                    with urllib.request.urlopen(
                        req, timeout=min(timeout, remaining)
                    ) as resp:
                        return resp.read()
            except urllib.error.HTTPError as e:
                if not (retry.retry_5xx and e.code in (502, 503, 504)
                        and retriable) or attempt + 1 >= attempts:
                    raise
                # drain the socket but keep the body READABLE: the deadline
                # may end the loop and re-raise this error, and callers read
                # the server's error detail from it. Reassigning e.fp is NOT
                # enough (addinfourl delegates read() to the original file),
                # so rebuild the error around a buffered body.
                try:
                    last_exc = urllib.error.HTTPError(
                        e.url, e.code, e.reason, e.headers,
                        io.BytesIO(e.read())
                    )
                except Exception:  # noqa: BLE001 — body already gone
                    last_exc = e
                    e.close()
            except TRANSIENT_ERRORS as e:
                last_exc = e
            if attempt + 1 >= attempts:
                break
            sleep = min(delay, retry.max_delay,
                        max(0.0, deadline - time.monotonic()))
            if sleep > 0:
                time.sleep(sleep * (1.0 - retry.jitter * _random.random()))
            delay *= retry.multiplier
        if last_exc is None:
            last_exc = TimeoutError(
                f"{method} {url}: retry deadline ({retry.deadline}s) exhausted"
            )
        raise last_exc


# -- idempotency (server side) -----------------------------------------------


class IdempotencyCache:
    """Bounded dedup window for idempotency-keyed requests.

    ``begin(key)`` -> ("new", None) | ("inflight", None) |
    ("replay", (code, obj)). The caller runs the real work only on "new",
    then ``commit(key, code, obj)`` on success or ``abort(key)`` on
    failure (so a retry after a FAILED attempt re-executes instead of
    replaying the failure). "inflight" means the original attempt is still
    executing — the server answers 503 and the client's backoff lands the
    retry after commit/abort. Entries expire after ``ttl`` seconds and the
    window holds at most ``capacity`` committed responses (FIFO)."""

    _INFLIGHT = object()

    def __init__(self, capacity: int = 1024, ttl: float = 300.0) -> None:
        self.capacity = capacity
        self.ttl = ttl
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[object, float]]" = OrderedDict()

    def begin(self, key: str) -> Tuple[str, Optional[tuple]]:
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                value, ts = entry
                if value is not self._INFLIGHT and now - ts > self.ttl:
                    del self._entries[key]
                elif value is self._INFLIGHT:
                    return "inflight", None
                else:
                    return "replay", value  # (code, obj)
            self._entries[key] = (self._INFLIGHT, now)
            return "new", None

    def commit(self, key: str, code: int, obj) -> None:
        with self._lock:
            self._entries[key] = ((code, obj), time.monotonic())
            if len(self._entries) > self.capacity:
                # trim oldest COMMITTED entries only: evicting an INFLIGHT
                # marker would let that key's retry re-execute concurrently
                # with its original — the double-execution this cache
                # exists to prevent
                for k in list(self._entries):
                    if len(self._entries) <= self.capacity:
                        break
                    if self._entries[k][0] is not self._INFLIGHT:
                        del self._entries[k]

    def abort(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)


def run_idempotent(handler, cache: IdempotencyCache, key: Optional[str],
                   fn, on_replay=None) -> None:
    """Execute ``fn() -> (code, obj)`` under the Idempotency-Key contract
    and write the JSON reply — THE one implementation of the dance, shared
    by the agent's /allocate and the controller's /pods so the semantics
    can never drift: committed keys replay (``on_replay`` hook for
    counters), a key whose original attempt is still executing answers 503
    (retryable — the client's backoff lands after commit/abort), success
    commits, anything else aborts so a retry re-executes. Exceptions
    propagate to the caller's error mapping after the abort."""
    if not key:
        write_json(handler, *fn())
        return
    state, stored = cache.begin(key)
    if state == "replay":
        if on_replay is not None:
            on_replay()
        write_json(handler, *stored)
        return
    if state == "inflight":
        write_json(handler, 503,
                   {"error": "idempotent request still in flight"})
        return
    try:
        code, obj = fn()
    except BaseException:
        cache.abort(key)
        raise
    if code == 200:
        cache.commit(key, code, obj)
    else:
        cache.abort(key)
    write_json(handler, code, obj)


class _InflightBracket:
    __slots__ = ("_tracker",)

    def __init__(self, tracker: "InflightTracker") -> None:
        self._tracker = tracker

    def __enter__(self):
        with self._tracker._cv:
            self._tracker._n += 1

    def __exit__(self, *exc):
        with self._tracker._cv:
            self._tracker._n -= 1
            self._tracker._cv.notify_all()


class InflightTracker:
    """Counts in-flight HTTP requests so a graceful shutdown can wait for
    them — shared by both wire servers (one implementation, zero drift)."""

    def __init__(self) -> None:
        self._n = 0
        self._cv = threading.Condition()

    def track(self) -> _InflightBracket:
        """Context manager bracketing one request."""
        return _InflightBracket(self)

    def wait_idle(self, timeout: float) -> bool:
        """Block (bounded) until no request is in flight."""
        with self._cv:
            return self._cv.wait_for(lambda: self._n == 0, timeout=timeout)


def handle_guarded(server, handler, dispatch) -> None:
    """THE per-request bracket both wire servers wrap every HTTP verb in:
    count the request in flight (so graceful shutdown can wait), adopt the
    caller's trace context (``X-Kubetpu-Trace-Id`` headers) and open a
    server span, consult the server's fault injector (chaos
    drop/delay/error/partial), then run *dispatch*. Lives here so the
    order (track -> trace -> faults -> route) can never drift between the
    agent and the controller. *server* needs ``._inflight``
    (InflightTracker) and ``.faults`` attributes; an ``.obs_component``
    string names the server in span records."""
    comp = getattr(server, "obs_component", type(server).__name__)
    with server._inflight.track():
        with obs_trace.attach_wire_context(handler.headers):
            with obs_trace.span(
                f"{handler.command} {handler.path}", component=comp
            ) as sp:
                if server.faults is not None and server.faults.server_fault(
                        handler):
                    # drop/error consumed the request before routing —
                    # visible in the trace as a server span that did no work
                    sp.tag(fault="injected")
                    return
                dispatch()
