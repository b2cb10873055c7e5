"""``ReplicaServer`` — one serving replica's wire surface for the data
plane (port of ``kubetpu/router/replica.py``).

The protocol, the endpoints and their answers are the JAX package's, over
the port's own copies of the wire, obs and codec modules, so a port
replica sits behind a ``kubetpu`` router and trades migrated streams with
a ``kubetpu`` replica. ``/adapters`` hot-loads and evicts adapters on a
multi-LoRA server (``jobs.multi_lora``) and answers 404 on a server
without ``load_adapter``; a generate naming an adapter reaches a
multi-LoRA server and is refused 400 elsewhere: the JAX package's
answers.

The slot servers (``DecodeServer`` / ``PagedDecodeServer`` and friends)
are in-process objects; ``obs.exporter.MetricsServer`` gave them a
read-only scrape surface, but nothing could *send them work* over the
wire. This server is that missing half — the leg the affinity router
(``kubetpu.router.server``) POSTs to:

    GET  /healthz    -> {"ok": true, "replica": <name>,
                         "draining": <bool>}  (open, liveness)
    GET  /load       -> ``server.load_info()`` + draining flag: the
                        CHEAP routing signal (queue depth, active
                        slots, pool free pages, prefix-cache hit rate)
                        the router polls instead of parsing /metrics
    GET  /metrics    -> Prometheus text of the serving registry
                        (latency summaries, pool gauges, prefix
                        counters, and this server's replica counters)
    GET  /slo        -> the replica's declared-SLO verdicts (JSON)
    GET  /events     -> replica + serving event logs, merged JSONL
    GET  /trace/<id> -> finished spans of one trace (the replica leg of
                        a stitched router trace)
    POST /generate   -> {"prompt": [ids], "sampling": {...}?,
                        "adapter": name or index?, "timeout": s?} ->
                        {"rid", "tokens", "emitted"}
                        — synchronous generate: enqueue, wait for the
                        step loop to finish the request, return
                        prompt + emitted tokens. A stream that MIGRATED
                        away mid-generate answers 409 with the new
                        owner ({"migrated": {replica, rid, epoch}}) so
                        the router can re-pin and retry there
    POST /drain      -> stop accepting generates (503); in-flight
                        requests run to completion — or, with
                        {"migrate_to": url}, are handed off live and
                        the drain completes immediately
    POST /migrate_out-> {"target": url, "reason"?, "wait"?} — snapshot
                        every migratable stream and hand it to the
                        target replica (the breaker-suspect and
                        drain-escalation leg)
    POST /migrate_in -> the chunked snapshot transfer (Round-16):
                        phase "begin" (meta + chunk count) -> "chunk"*N
                        (base64 blob slices) -> "commit" (restore +
                        adoption). Every phase POST carries an
                        Idempotency-Key derived from the stream's
                        (origin, rid, epoch), so a lost response
                        REPLAYS — a retry can never double-restore;
                        the commit additionally EPOCH-FENCES per
                        (origin, rid): a stale or duplicate handoff
                        generation is refused 409, keeping at most one
                        copy of a stream active fleet-wide
    POST /adapters   -> {"action": "load", "name"?, "adapter": wire
                        tree} | {"action": "evict", "name"} — hot load
                        or evict a LoRA adapter on a multi-LoRA server
                        (404 elsewhere; 409 evicting an adapter in use)

Robustness (the Round-7 contract, uniformly):

- **idempotent generate**: a ``Idempotency-Key``-carrying POST is
  deduped through a bounded replay window (``run_idempotent``). A
  router retry whose first response was truncated mid-write gets the
  committed tokens REPLAYED — never a second admission, so a lost
  response can never double-allocate slots/pool pages (pinned by
  ``make router-check`` under injected partial faults);
- **graceful drain**: ``drain()`` refuses NEW generates with 503 while
  requests already admitted (or waiting on the handler) complete —
  the autoscaler's scale-down path depends on this (drain first,
  remove only once ``/load`` reads idle). ``drain(migrate_to=url)``
  upgrades the wait to a LIVE HANDOFF: every in-flight stream
  snapshots to the target token-exactly and the drain completes as
  fast as the wire, not as slow as the longest stream.
  ``drain_timeout_s`` bounds the no-migration wait: past it, remaining
  streams either escalate to migration (a target was named) or cancel
  with a ``drain_timeout`` event — scale-down never wedges behind one
  long-max_tokens stream;
- **at-most-one-active migration**: the source retires a migrated slot
  only after the target's commit-ack; an AMBIGUOUS outcome (transport
  dead past the retry budget) finishes the stream as migrated rather
  than resuming — the target may have committed, and a resumed copy
  would double-run the stream. Only a DEFINITIVE refusal (an HTTP
  error answer) unfreezes and resumes locally;
- **fault injection**: ``faults=FaultInjector(...)`` chaos-tests the
  surface like every other wire server;
- **meshed servers**: a server built with ``mesh=`` is served by the
  mesh's first rank while every other rank runs ``follow_replica``; the
  calls that change the ranks' host state reach them in rank 0's order
  (the last section below), and a follower that fails stops the replica.

Threading: the slot servers are NOT thread-safe, so one condition
variable serializes everything that touches the serving object — the
background step loop (``_poll_loop``: step while work exists, sleep
while idle) and the handler-side enqueue/result reads. Handlers block
on the condition between polls, so a finishing request wakes its waiter
within one step. This is the honest single-replica spelling: the
serving hot loop already runs one step at a time; the lock adds a
handler's enqueue (host-side bookkeeping, microseconds) to that serial
order, never a device wait.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubetpu_torch.api import utils
from kubetpu_torch.obs import trace as obs_trace
from kubetpu_torch.obs.events import EventLog, merge_events
from kubetpu_torch.router.migration import (
    DEFAULT_CHUNK_BYTES,
    assemble_spans,
    blob_chunks,
    chunk_b64,
    chunk_unb64,
    decode_snapshot,
    decode_span_payload,
    encode_array,
    encode_snapshot,
    encode_span_payload,
    span_name,
)
from kubetpu_torch.wire.httpcommon import (
    IdempotencyCache,
    InflightTracker,
    RetryPolicy,
    check_bearer,
    handle_guarded,
    request_json,
    run_idempotent,
    serve_events_jsonl,
    write_json,
    write_text,
)

DEFAULT_GENERATE_TIMEOUT = 30.0
DEFAULT_MIGRATE_TIMEOUT = 20.0
# staging slots for inbound chunked transfers: stale entries (a source
# that died mid-ship) are reaped after this many seconds
MIGRATE_STAGING_TTL = 60.0


class ReplicaServer:
    """Serve one slot server (``SlotServerBase`` contract) to the
    router data plane."""

    def __init__(
        self,
        server,
        name: str,
        host: str = "127.0.0.1",
        port: int = 0,
        token: "str | None" = None,
        faults=None,
        idem_window: float = 300.0,
        idle_wait: float = 0.005,
        drain_timeout_s: Optional[float] = None,
        migrate_timeout: float = DEFAULT_MIGRATE_TIMEOUT,
        migrate_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        role: str = "both",
        handoff_workers: int = 2,
    ) -> None:
        """*server*: the serving object (enqueue/step/finished/
        pop_result/load_info — ``SlotServerBase`` and every subclass).
        *idle_wait*: step-loop sleep while the server is idle (bounds
        enqueue-to-first-step latency when work arrives).
        *drain_timeout_s*: bound on a no-migration drain's wait for
        natural stream end — past it, remaining streams escalate to
        migration (when a target was named) or cancel with a
        ``drain_timeout`` event, so scale-down never wedges behind one
        long-max_tokens stream. None = wait forever (the pre-Round-16
        behavior).
        *role* (Round-17 disaggregated serving): ``"prefill"`` makes
        this replica a PREFILL worker — a routed generate carrying a
        ``decode_target`` admits + chunk-prefills here, STREAMS its
        completed page-aligned KV spans to that decode replica while
        later chunks are still computing, and hands the stream off on
        first token (the decode replica emits every token). ``"decode"``
        advertises a decode worker (the router stops sending it fresh
        prompts); ``"both"`` (default) is today's colocated behavior —
        the topology is opt-in, and a role is ADVISORY for routing:
        every replica remains a full server (a refused handoff resumes
        locally)."""
        if role not in ("prefill", "decode", "both"):
            raise ValueError("role must be 'prefill', 'decode' or 'both'")
        self.role = role
        if int(handoff_workers) < 1:
            raise ValueError("handoff_workers must be >= 1")
        self.handoff_workers = int(handoff_workers)
        self._cv = threading.Condition()
        # a meshed server: this rank serves, the others follow
        # (``follow_replica``); every recorded call reaches them in order
        self._lockstep: Optional[_Lockstep] = None
        if getattr(server, "mesh", None) is not None:
            self._lockstep = _Lockstep(server)
            if not self._lockstep.leader:
                raise ValueError("a meshed server's replica runs on the "
                                 "mesh's first rank; the other ranks call "
                                 "follow_replica")
            server = _RecordedServer(server, self._lockstep, self._cv)
        self.server = server
        self.name = name
        # Round-20 boot-nonce fencing: a fresh identity every process
        # boot, advertised in /healthz and /load. The pool compares it
        # across probes — a same-name replica answering with a NEW nonce
        # is a hard-killed-and-restarted (cache-wiped) process, and the
        # router unpins its mid-stream rids for re-drive on survivors.
        self.boot_nonce = uuid.uuid4().hex
        self.token = token or None
        self.faults = faults
        self.idem = IdempotencyCache(ttl=idem_window)
        self.obs_component = f"replica:{name}"
        self.events = EventLog(component=self.obs_component)
        self.draining = False
        self._inflight = InflightTracker()
        self._running = False
        self._idle_wait = float(idle_wait)
        if drain_timeout_s is not None and drain_timeout_s < 0:
            raise ValueError("drain_timeout_s must be >= 0 (None = wait)")
        self.drain_timeout_s = drain_timeout_s
        self.migrate_timeout = float(migrate_timeout)
        if int(migrate_chunk_bytes) <= 0:
            raise ValueError("migrate_chunk_bytes must be positive")
        self.migrate_chunk_bytes = int(migrate_chunk_bytes)
        # -- live-migration state (all under self._cv: the handlers, the
        # step loop and the drain-migrate thread share it):
        # rid -> the generate leg's Idempotency-Key (shipped in the
        # snapshot meta so the TARGET can adopt a router retry of the
        # same logical request into the restored stream)
        self._gen_keys: dict = {}
        # gen key -> restored local rid, installed at migrate-in commit
        # and consumed by the first /generate carrying that key
        # (bounded: an orphaned handoff whose retry never arrives must
        # not leak an entry per stream forever)
        self._adopted: "OrderedDict[str, int]" = OrderedDict()
        # gen key -> migrated-away info: a retry of a migrated request
        # must deterministically re-learn the new owner (409), never
        # re-admit here (run_idempotent only replays 200s)
        self._migrated_keys: "OrderedDict[str, dict]" = OrderedDict()
        # inbound chunked transfers: (origin, rid, epoch) -> staging
        self._mig_staging: dict = {}
        # the EPOCH FENCE: (origin, rid) -> highest committed epoch; a
        # commit at <= that epoch is a duplicate/stale handoff and is
        # refused — at most one copy of a stream ever goes active
        self._mig_epochs: "OrderedDict[tuple, int]" = OrderedDict()
        self._drain_migrate: Optional[str] = None
        self._drain_deadline: Optional[float] = None
        self._drain_thread: Optional[threading.Thread] = None
        # -- Round-17 disaggregated handoffs (prefill role only): rid ->
        # streaming-transfer state machine, driven by the handoff loop
        # thread; all mutation under self._cv
        self._handoffs: dict = {}
        self._handoff_thread: Optional[threading.Thread] = None
        # the pipelining proof: KV bytes shipped BEFORE the prefill
        # finished vs total handoff bytes (gauge below)
        self._handoff_early_bytes = 0
        self._handoff_bytes = 0
        # role is a federatable fact: the router's cli summary counts
        # per-role replicas from this series (value is always 1)
        self.server.obs.gauge("kubetpu_serving_role", role=role).set(1.0)
        self.server.obs.gauge_fn("kubetpu_handoffs_inflight",
                                 lambda: len(self._handoffs))
        self.server.obs.gauge_fn(
            "kubetpu_handoff_overlap_frac",
            lambda: (self._handoff_early_bytes / self._handoff_bytes
                     if self._handoff_bytes else 0.0))
        # replica wire counters land on the SERVING registry so one
        # /metrics scrape carries both (the router federates it whole)
        for key in ("requests", "replays", "errors", "adopted"):
            # key ranges over the fixed literal tuple above — KTP004's
            # bounded-f-string proof expands and validates every name
            self.server.obs.counter(f"kubetpu_replica_generate_{key}_total")
        replica = self

        def bump(key: str) -> None:
            # callers pass literals from the pre-registered set above
            # ktlint: disable=KTP004
            replica.server.obs.counter(
                f"kubetpu_replica_generate_{key}_total").inc()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
                utils.logf(5, "replica %s: " + fmt, replica.name, *args)

            def _authorized(self) -> bool:
                if check_bearer(self.headers, replica.token):
                    return True
                write_json(self, 401,
                           {"error": "missing or invalid bearer token"})
                return False

            def do_GET(self):  # noqa: N802
                handle_guarded(replica, self, self._do_get)

            def _do_get(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    failed = replica.lockstep_failed()
                    write_json(self, 503 if failed else 200, {
                        "ok": not failed,
                        "replica": replica.name,
                        "role": replica.role,
                        "draining": replica.draining,
                        "boot_nonce": replica.boot_nonce,
                    })
                elif not self._authorized():
                    pass  # 401 already sent
                elif path == "/load":
                    write_json(self, 200, replica.load())
                elif path == "/metrics":
                    write_text(self, 200, replica.server.metrics_text())
                elif path == "/slo":
                    slo = getattr(replica.server, "slo", None)
                    write_json(self, 200, {
                        "replica": replica.name,
                        "results": slo.results() if slo is not None else {},
                    })
                elif path == "/events":
                    serve_events_jsonl(self, replica.render_events)
                elif path.startswith("/trace/"):
                    tid = path[len("/trace/"):]
                    write_json(self, 200, {
                        "trace": tid,
                        "spans": obs_trace.tracer().spans(tid),
                    })
                else:
                    write_json(self, 404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                handle_guarded(replica, self, self._do_post_guarded)

            def _do_post_guarded(self):
                try:
                    self._do_post()
                except LockstepError as e:
                    # a meshed replica whose followers are gone serves
                    # nothing: a retryable refusal, never one rank's answer
                    write_json(self, 503, {"error": str(e)})

            def _do_post(self):
                if not self._authorized():
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    write_json(self, 400, {"error": "body is not JSON"})
                    return
                if self.path == "/drain":
                    replica.drain(migrate_to=req.get("migrate_to"),
                                  reason=req.get("reason") or "drain")
                    write_json(self, 200, {"draining": True})
                    return
                if self.path == "/migrate_out":
                    write_json(self, *replica._migrate_out(req))
                    return
                if self.path == "/migrate_in":
                    run_idempotent(
                        self, replica.idem,
                        self.headers.get("Idempotency-Key"),
                        lambda: replica._migrate_in(req),
                    )
                    return
                if self.path == "/prefix_fetch":
                    run_idempotent(
                        self, replica.idem,
                        self.headers.get("Idempotency-Key"),
                        lambda: replica._prefix_fetch(req),
                    )
                    return
                if self.path == "/adapters":
                    run_idempotent(
                        self, replica.idem,
                        self.headers.get("Idempotency-Key"),
                        lambda: replica._adapters(req),
                    )
                    return
                if self.path != "/generate":
                    write_json(self, 404, {"error": f"no route {self.path}"})
                    return

                def replayed():
                    bump("replays")
                    replica.events.emit("generate_replay")

                key = self.headers.get("Idempotency-Key")
                run_idempotent(
                    self, replica.idem, key,
                    lambda: replica._generate(req, key=key),
                    on_replay=replayed,
                )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None

    # -- the generate leg ----------------------------------------------------

    def _generate(self, req: dict, key: Optional[str] = None):
        """One generate execution -> (code, obj); runs on the handler
        thread under ``run_idempotent`` (200 commits into the replay
        window, anything else aborts so a retry re-executes). The
        draining refusal lives HERE, after the replay lookup: a keyed
        retry of an already-committed generate must get its replay even
        mid-drain (replaying mutates nothing). Round-16 additions: a
        keyed retry of a request that MIGRATED away deterministically
        answers 409 with the new owner (never re-admits here), and a
        keyed request whose stream migrated IN is ADOPTED — attached to
        the restored stream instead of admitted fresh (adoption works
        mid-drain too: attaching mutates nothing new)."""
        deadline = time.monotonic() + float(
            req.get("timeout") or DEFAULT_GENERATE_TIMEOUT)
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return 400, {"error": "prompt must be a non-empty list of "
                                  "token ids"}
        # Round-19 peer prefix tier: before taking the serving lock for
        # admission, try to pull this prompt's cached KV span from the
        # router-named peer (the ring's previous preference owner). The
        # HTTP leg runs OUTSIDE the condition — a slow or dark peer must
        # never stall the step loop — and any failure degrades to cold
        # prefill, so the admission below is untouched either way.
        self._maybe_peer_prefetch(req, prompt, key)
        with self._cv:
            gone = self._migrated_keys.get(key) if key else None
            if gone is not None:
                return 409, {"error": "request migrated",
                             "migrated": dict(gone)}
            adopted = self._adopted.pop(key, None) if key else None
            if adopted is None and key:
                # a retry of a request still LIVE here — its earlier
                # handler timed out (e.g. while the stream was frozen
                # mid-handoff) and run_idempotent aborted the entry, so
                # a naive path would re-ADMIT the same logical request
                # next to its own live stream. Re-attach instead.
                adopted = next(
                    (r for r, k in self._gen_keys.items()
                     if k == key and not self.server.finished(r)), None)
            if adopted is not None:
                rid = adopted
                self.server.obs.counter(
                    "kubetpu_replica_generate_adopted_total",
                    "router retries attached to a migrated-in stream "
                    "instead of admitted fresh").inc()
                self.events.emit("generate_adopt", rid=rid)
            else:
                if self.draining:
                    return 503, {"error": "replica is draining"}
                if not self._running:
                    return 503, {"error": "replica step loop is not "
                                          "running"}
                self.events.emit("generate", prompt_tokens=len(prompt))
                # a routed generate may name its LoRA adapter (a resident
                # name or a stack index); refused up front on a server
                # without LoRA: a silent drop would serve the base model
                # to a tenant expecting their adapter
                extra = {}
                if req.get("adapter") is not None:
                    if not hasattr(self.server, "lora_stack"):
                        return 400, {"error": "replica does not serve "
                                              "multi-LoRA"}
                    extra["adapter"] = req["adapter"]
                try:
                    rid = self.server.enqueue(prompt,
                                              sampling=req.get("sampling"),
                                              **extra)
                except ValueError as e:
                    return 400, {"error": str(e)}
                except Exception as e:  # noqa: BLE001 — report, stay up
                    self.server.obs.counter(
                        "kubetpu_replica_generate_errors_total").inc()
                    return 500, {"error": str(e)}
                self.server.obs.counter(
                    "kubetpu_replica_generate_requests_total").inc()
                if key:
                    self._gen_keys[rid] = key
                    self._gc_gen_keys_locked()
                # Round-17: a routed prompt naming a decode target on a
                # PREFILL replica registers a streaming handoff — the
                # handoff loop begins shipping completed KV spans while
                # later prefill chunks still compute. Only FRESH
                # admissions: an adopted/re-attached stream is already
                # decoding (possibly HERE after an earlier handoff was
                # refused) and must not be re-shipped by this leg.
                target = req.get("decode_target")
                if (self.role == "prefill" and isinstance(target, str)
                        and target):
                    self._register_handoff_locked(
                        rid, target, prompt,
                        target_name=req.get("decode_name"))
            self._cv.notify_all()
            while not self.server.finished(rid):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._running:
                    self.server.cancel(rid)
                    if self.server.finished(rid):
                        self.server.pop_result(rid)
                        self._gen_keys.pop(rid, None)
                    # a stream cancel() REFUSED (frozen mid-handoff)
                    # keeps its key binding: a retry of this key must
                    # RE-ATTACH to the live stream (or learn the 409
                    # after the handoff resolves), never re-admit
                    return 503, {"error": "generate deadline exceeded"
                                 if self._running else "replica stopping"}
                self._cv.wait(timeout=min(remaining, 0.25))
            self._gen_keys.pop(rid, None)
            mig = self.server.migrated_to(rid)
            if mig is not None:
                # the stream lives on elsewhere: remember the verdict
                # per key (a retry must re-learn it, not re-admit) and
                # reclaim local bookkeeping — the target owns the tokens
                if key:
                    self._migrated_keys[key] = dict(mig)
                    self._trim_locked(self._migrated_keys)
                self.server.pop_result(rid)
                return 409, {"error": "request migrated",
                             "migrated": dict(mig)}
            reason = self.server.expire_reason(rid)
            tokens = self.server.pop_result(rid)
        if reason is not None:
            return 503, {"error": f"request expired: {reason}"}
        return 200, {
            "rid": rid,
            "replica": self.name,
            "tokens": tokens,
            "emitted": tokens[len(prompt):],
        }

    # -- Round-19: cross-replica prefix tier ---------------------------------
    #
    # The fleet tier of the tiered KV cache: a replica that misses
    # locally on a routed prompt asks ONE peer — the ring's previous
    # preference owner, named by the router in the generate payload —
    # for the span it has cached, and adopts it before cold-prefilling.
    # The exporter side is read-only (export under the condition, no
    # serving-state mutation), so the exchange is naturally idempotent;
    # the importer's tree-insert consumes nothing it already covers, so
    # a replayed fetch commits at most once. A dark, slow, or faulted
    # peer degrades to cold prefill — the tier can only remove work.

    PEER_FETCH_RETRY = RetryPolicy(attempts=2, deadline=2.0)

    def _prefix_fetch(self, req: dict):
        """``POST /prefix_fetch`` — export this replica's cached
        coverage of ``prompt`` from logical page ``from_page`` on, as an
        ``encode_span_payload`` body -> (code, obj). 404 when the tree
        covers nothing past ``from_page`` (the requester cold-prefills);
        read-only either way."""
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return 400, {"error": "prompt must be a non-empty list of "
                                  "token ids"}
        try:
            from_page = int(req.get("from_page") or 0)
        except (TypeError, ValueError):
            return 400, {"error": "from_page must be an integer"}
        if from_page < 0:
            return 400, {"error": "from_page must be >= 0"}
        export = getattr(self.server, "export_prefix_span", None)
        if export is None:
            return 404, {"error": "replica has no prefix tier"}
        with self._cv:
            span = export(prompt, from_page=from_page)
        if span is None:
            self.server.obs.counter("kubetpu_peer_prefix_export_total",
                                    result="miss").inc()
            return 404, {"error": "no cached coverage past from_page"}
        self.server.obs.counter("kubetpu_peer_prefix_export_total",
                                result="hit").inc()
        self.events.emit("prefix_export", pages=int(span["n_pages"]),
                         from_page=int(span["from_page"]))
        return 200, {
            "replica": self.name,
            "matched_tokens": int(span["matched_tokens"]),
            "from_page": int(span["from_page"]),
            "n_pages": int(span["n_pages"]),
            "span": encode_span_payload(span["pages"],
                                        int(span["from_page"])),
        }

    # -- adapter hot load / evict --------------------------------------------

    def _adapters(self, req: dict):
        """``POST /adapters``, the multi-LoRA control-plane leg -> (code,
        obj), under ``run_idempotent`` (a lost response replays).
        Actions:

        - ``load``: decode the wire adapter and hot-load it into the
          serving stack (content-idempotent: a replayed or re-keyed load
          of a resident adapter is a no-op). 503 when the stack is full of
          in-use adapters (retryable: requests drain), 400 on a malformed
          or mismatched payload;
        - ``evict``: drop the named adapter from the directory. 409 while
          a live request references it; ``evicted: false`` when already
          gone (replay-idempotent).

        Both answers carry the post-action resident set. 404 on a server
        without ``load_adapter``."""
        load_fn = getattr(self.server, "load_adapter", None)
        evict_fn = getattr(self.server, "evict_adapter", None)
        if load_fn is None or evict_fn is None:
            return 404, {"error": "replica does not serve multi-LoRA"}
        action = str(req.get("action") or "load")
        if action == "load":
            from kubetpu_torch.router.adapters import decode_adapter
            try:
                adapter = decode_adapter(req.get("adapter") or {})
            except ValueError as e:
                return 400, {"error": str(e)}
            name = req.get("name")
            if name is not None and not isinstance(name, str):
                return 400, {"error": "adapter name must be a string"}
            try:
                with self._cv:
                    out = load_fn(adapter, name=name)
                    resident = self.server.resident_adapters()
            except ValueError as e:
                return 400, {"error": str(e)}
            except RuntimeError as e:
                # every index pinned by live requests: transient, the
                # keyed retry lands after streams drain
                return 503, {"error": str(e)}
            self.events.emit("adapter_wire_load", name=out)
            return 200, {"name": out, "resident": resident,
                         "replica": self.name}
        if action == "evict":
            name = req.get("name")
            if not isinstance(name, str) or not name:
                return 400, {"error": "evict needs an adapter name"}
            try:
                with self._cv:
                    evicted = evict_fn(name)
                    resident = self.server.resident_adapters()
            except RuntimeError as e:
                return 409, {"error": str(e)}
            self.events.emit("adapter_wire_evict", name=name,
                             evicted=bool(evicted))
            return 200, {"evicted": bool(evicted), "resident": resident,
                         "replica": self.name}
        return 400, {"error": f"unknown adapter action {action!r}"}

    def _maybe_peer_prefetch(self, req: dict, prompt: list,
                             key: Optional[str]) -> None:
        """Best-effort pull of *prompt*'s KV span from the peer the
        router named (``prefix_peer`` in the generate payload). Probes
        local coverage under the condition, runs the HTTP leg unlocked
        (local coverage may move meanwhile — ``inject_prefix`` detects
        the hole and refuses), injects under the condition. EVERY
        failure path is a silent degrade to cold prefill."""
        peer = req.get("prefix_peer")
        if not isinstance(peer, str) or not peer:
            return
        inject = getattr(self.server, "inject_prefix", None)
        local_fn = getattr(self.server, "prefix_local_pages", None)
        if inject is None or local_fn is None:
            return
        ps = int(getattr(self.server, "page_size", 0) or 0)
        if ps <= 0:
            return
        # full cached pages a prefill at pos=matched can ever use: the
        # last prompt token is recomputed, hence the -1
        full = (len(prompt) - 1) // ps
        if full <= 0:
            return
        with self._cv:
            local = int(local_fn(prompt))
        if local >= full:
            return                       # already covered locally

        def count(result: str) -> None:
            self.server.obs.counter("kubetpu_peer_prefix_fetch_total",
                                    result=result).inc()

        try:
            resp = request_json(
                peer.rstrip("/") + "/prefix_fetch",
                {"prompt": [int(t) for t in prompt], "from_page": local},
                token=self.token,
                retry=self.PEER_FETCH_RETRY,
                timeout=self.PEER_FETCH_RETRY.deadline,
                idempotency_key=(
                    f"prefix-fetch-{key or uuid.uuid4().hex[:12]}"),
            )
            pages = decode_span_payload(resp["span"])
            matched = int(resp["matched_tokens"])
            from_page = int(resp["from_page"])
        except urllib.error.HTTPError as e:
            count("miss" if e.code == 404 else "degraded")
            if e.code != 404:
                self.events.emit("prefix_fetch_degraded", peer=peer,
                                 code=e.code)
            return
        except Exception as e:  # noqa: BLE001 — any wire/codec failure
            count("degraded")
            self.events.emit("prefix_fetch_degraded", peer=peer,
                             error=str(e)[:120])
            return
        try:
            with self._cv:
                adopted = inject(prompt[:matched], pages,
                                 from_page=from_page)
        except (ValueError, AssertionError) as e:
            count("degraded")
            self.events.emit("prefix_fetch_degraded", peer=peer,
                             error=str(e)[:120])
            return
        count("hit" if adopted else "miss")
        self.events.emit("prefix_fetch", peer=peer, pages=int(adopted),
                         matched_tokens=matched)

    # -- live KV migration (Round-16) ----------------------------------------

    def migrate_rid(self, rid: int, target_url: str,
                    reason: str = "manual") -> bool:
        """Hand ONE in-flight stream to *target_url* token-exactly:
        snapshot + freeze under the condition (the step loop pauses the
        slot, nothing else moves it), ship the snapshot as idempotency-
        keyed begin/chunk*N/commit POSTs (keys derive from the stream's
        (origin, rid, epoch) — a lost response replays, never a second
        restore), and retire the local slot only after the target's
        commit-ack. Outcomes:

        - **committed**: target ack'd — the slot retires as migrated
          (callers get 409 + the new owner);
        - **refused** (definitive HTTP error answer): the slot
          unfreezes and resumes locally, token-exactly;
        - **fenced** (409 fenced): another copy already owns the stream
          at >= this epoch — never resume (at-most-one-active);
        - **ambiguous** (transport dead past the retry budget): the
          target MAY have committed, so resuming could double-run the
          stream — the slot finishes as migrated toward the attempted
          target; a router retry either adopts the restored stream or
          re-admits fresh (token-exact either way).

        Counted as ``kubetpu_migrations_total{reason,result}``."""
        target_url = target_url.rstrip("/")
        with self._cv:
            try:
                snap = self.server.snapshot_slot(rid)
            except (ValueError, NotImplementedError) as e:
                self.events.emit("migrate_skip", rid=rid, error=str(e))
                return False
            self.server.freeze_slot(rid)
            # the stream's generate key: from an attached handler, or —
            # for a migrated-IN stream whose router retry has not landed
            # yet — from the adoption map. It ships in the meta so the
            # key keeps following the stream across EVERY hop.
            gen_key = self._gen_keys.get(rid)
            if gen_key is None:
                gen_key = next((k for k, v in self._adopted.items()
                                if v == rid), None)
        try:
            # from freeze to the wire leg, ANY failure must unfreeze —
            # a raise here would otherwise wedge the stream frozen with
            # no resolution path (no commit, no refusal)
            origin = list(snap.get("origin") or (self.name, rid))
            epoch = int(snap.get("epoch", 0)) + 1
            snap["origin"] = origin
            snap["epoch"] = epoch
            pages = snap["pages"]
            n_live = int(snap["n_live_pages"])
            meta = {k: v for k, v in snap.items() if k != "pages"}
            meta["gen_key"] = gen_key
            meta["reason"] = reason
            meta["source"] = self.name
            tok = {"origin": origin, "epoch": epoch}
            # keys are per ATTEMPT (nonce), not per epoch: retries
            # inside request_json reuse them (lost-response replay),
            # while a fresh migrate_rid call after a REFUSAL re-stages
            # under new keys — an epoch-only key would replay the old
            # begin 200 against deleted staging and spin hopelessly.
            # At-most-once is the commit fence's job (a second commit
            # at the same epoch is refused), not the key's.
            kbase = (f"mig-{origin[0]}-{origin[1]}-e{epoch}-"
                     f"{uuid.uuid4().hex[:8]}")
        except Exception:
            with self._cv:
                self.server.unfreeze_slot(rid)
                self._cv.notify_all()
            raise
        self.events.emit("migrate_begin", rid=rid, target=target_url,
                         reason=reason, epoch=epoch)
        # Outcome classification is PER LEG: only a failure of the
        # COMMIT POST can mask an executed (or still-executing) restore
        # — begin/chunk/encode failures provably left no copy at the
        # target (staging is not a stream; its TTL reaps it), so the
        # source resumes token-exactly. A commit-phase 4xx is a
        # definitive ANSWER of non-commit (restore raised / staging
        # gone); a commit-phase 5xx or transport death is AMBIGUOUS
        # (run_idempotent's in-flight 503 can outlive the retry budget
        # while the restore still runs) and must never resume.
        leg = "begin"
        try:
            with obs_trace.span("migrate.out",
                                component=self.obs_component,
                                reason=reason):
                resp = request_json(
                    target_url + "/migrate_in",
                    {"phase": "begin", "token": tok, "meta": meta},
                    token=self.token, idempotency_key=kbase + "-begin",
                    timeout=self.migrate_timeout)
                # the target's prefix hint: pages it can map read-only
                # from its own cache never cross the wire — ship only
                # the uncached suffix (commit re-checks; a receded
                # match refuses and we resume + re-ship). Encoded ONCE,
                # after the hint, so a warm-target handoff never pays a
                # full-blob copy it then throws away.
                skip = min(max(0, int(resp.get("skip_pages") or 0)),
                           n_live)
                ship = (pages if skip == 0 else
                        {n: a[:, skip:] for n, a in pages.items()})
                enc, blob = encode_snapshot({"pages": ship})
                arrays, ship_from = enc["arrays"], skip
                chunks = blob_chunks(blob, self.migrate_chunk_bytes)
                leg = "chunk"
                for i, chunk in enumerate(chunks):
                    request_json(
                        target_url + "/migrate_in",
                        {"phase": "chunk", "token": tok, "seq": i,
                         "data": chunk_b64(chunk)},
                        token=self.token,
                        idempotency_key=f"{kbase}-c{i}",
                        timeout=self.migrate_timeout)
                leg = "commit"
                ack = request_json(
                    target_url + "/migrate_in",
                    {"phase": "commit", "token": tok,
                     "n_chunks": len(chunks), "arrays": arrays,
                     "ship_from_page": ship_from},
                    token=self.token, idempotency_key=kbase + "-commit",
                    timeout=self.migrate_timeout)
        except urllib.error.HTTPError as e:
            detail = {}
            try:
                detail = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001 — body unreadable/withheld
                pass
            if detail.get("fenced"):
                info = {"replica": detail.get("replica"),
                        "epoch": int(detail.get("epoch", epoch)),
                        "fenced": True}
                with self._cv:
                    self.server.finish_migrated(rid, info)
                    self._note_stream_left_locked(rid, gen_key, info)
                    self._cv.notify_all()
                self._count_migration(reason, "fenced")
                return False
            if e.code < 500 or leg != "commit":
                with self._cv:
                    self.server.unfreeze_slot(rid)
                    self._cv.notify_all()
                self._count_migration(reason, "refused")
                self.events.emit("migrate_refused", rid=rid, code=e.code,
                                 leg=leg,
                                 error=str(detail.get("error", ""))[:120])
                return False
            return self._migrate_ambiguous(rid, gen_key, target_url,
                                           epoch, reason,
                                           f"HTTP {e.code} on commit")
        except Exception as e:  # noqa: BLE001 — transport death
            if leg != "commit":
                # no commit POST was ever sent: the target cannot hold
                # a copy — resume, don't sacrifice the stream
                with self._cv:
                    self.server.unfreeze_slot(rid)
                    self._cv.notify_all()
                self._count_migration(reason, "refused")
                self.events.emit("migrate_refused", rid=rid, code=0,
                                 leg=leg, error=str(e)[:120])
                return False
            return self._migrate_ambiguous(rid, gen_key, target_url,
                                           epoch, reason, str(e))
        info = {"replica": ack.get("replica"), "rid": ack.get("rid"),
                "epoch": epoch}
        with self._cv:
            self.server.finish_migrated(rid, info)
            self._note_stream_left_locked(rid, gen_key, info)
            self._cv.notify_all()
        self.server.obs.counter(
            "kubetpu_migration_bytes_shipped_total",
            "snapshot blob bytes shipped over /migrate_in").inc(len(blob))
        self._count_migration(reason, "committed")
        self.events.emit("migrate_commit", rid=rid,
                         target=ack.get("replica"), epoch=epoch)
        return True

    def _count_migration(self, reason: str, result: str) -> None:
        self.server.obs.counter("kubetpu_migrations_total",
                                reason=reason, result=result).inc()

    def _migrate_ambiguous(self, rid: int, gen_key: Optional[str],
                           target_url: str, epoch: int, reason: str,
                           err: str) -> bool:
        """A commit whose outcome is unknowable (transport death or a
        5xx that can mask a still-executing restore): the stream
        finishes as migrated toward the attempted target — resuming
        could double-run it, and at-most-one-active beats finishing
        here. The router retry adopts the restored copy or re-computes
        fresh; token-exact either way."""
        info = {"replica": None, "url": target_url, "epoch": epoch,
                "ambiguous": True}
        with self._cv:
            self.server.finish_migrated(rid, info)
            self._note_stream_left_locked(rid, gen_key, info)
            self._cv.notify_all()
        self._count_migration(reason, "ambiguous")
        self.events.emit("migrate_ambiguous", rid=rid, error=err[:120])
        return False

    @staticmethod
    def _trim_locked(od: OrderedDict, cap: int = 4096) -> None:
        """Caller holds ``self._cv``: FIFO-evict the oldest entries
        past *cap* — the one spelling of every bounded map's policy."""
        while len(od) > cap:
            od.popitem(last=False)

    def _gc_gen_keys_locked(self) -> None:
        """Caller holds ``self._cv``: drop generate-key entries whose
        rid is no longer unfinished (adopted-but-never-attached streams
        that completed naturally) once the map grows past the cap."""
        if len(self._gen_keys) > 4096:
            live = set(self.server.unfinished_rids())
            for r in [r for r in self._gen_keys if r not in live]:
                del self._gen_keys[r]

    def _note_stream_left_locked(self, rid: int, gen_key: Optional[str],
                                 info: dict) -> None:
        """Caller holds ``self._cv``. A stream just left this replica:
        retire its key bookkeeping and record the 409 verdict per key,
        so ANY later visit with that key — an attached handler's retry,
        or a router attempt chasing a multi-hop stream that was adopted
        here but never attached — deterministically re-learns the new
        owner instead of re-admitting (the at-most-one-active ledger
        depends on this surviving every hop). *gen_key* is the caller's
        already-resolved key — ``migrate_rid`` resolves it once through
        both the attached and adopted maps before the wire leg."""
        self._gen_keys.pop(rid, None)
        if gen_key is not None:
            self._adopted.pop(gen_key, None)
            self._migrated_keys[gen_key] = dict(info)
            self._trim_locked(self._migrated_keys)

    def migrate_all(self, target_url: str,
                    reason: str = "manual") -> "tuple[int, int]":
        """Migrate every currently-migratable stream to *target_url*
        -> (committed, not_committed)."""
        with self._cv:
            rids = self.server.migratable_rids()
        done = failed = 0
        for rid in rids:
            if self.migrate_rid(rid, target_url, reason=reason):
                done += 1
            else:
                failed += 1
        return done, failed

    def _migrate_out(self, req: dict):
        """``POST /migrate_out`` — the policy layer's push-button:
        snapshot every migratable stream toward ``target``. ``wait``
        (default true) runs inline and returns counts; false kicks a
        background sweep (the router's breaker-suspect path, which
        must not stall its signals loop on a slow transfer)."""
        target = req.get("target")
        if not isinstance(target, str) or not target:
            return 400, {"error": "target url required"}
        reason = str(req.get("reason") or "manual")
        if req.get("wait", True):
            done, failed = self.migrate_all(target, reason=reason)
            return 200, {"migrated": done, "failed": failed}
        with self._cv:
            pending = len(self.server.migratable_rids())
        threading.Thread(
            target=self.migrate_all, args=(target, reason),
            name=f"kubetpu-replica-migrate-out-{self.name}",
            daemon=True).start()
        return 200, {"started": pending}

    # -- Round-17: disaggregated prefill -> decode streaming handoff ---------
    #
    # The prefill role's whole point: a routed generate carrying a
    # ``decode_target`` admits + chunk-prefills HERE, but every token is
    # emitted at the decode replica. The transfer rides the Round-16
    # begin/chunk/commit wire path with the SAME per-(origin, rid,
    # epoch) idempotency keys and commit-only retirement — what changes
    # is WHEN bytes move: completed page-aligned KV spans ship while
    # later prefill chunks are still computing (each span is its own
    # manifest entry, ``migration.span_name``), so by first token only
    # the tail pages + request meta remain. The state machine:
    #
    #   begin    POST the prompt + identity; learn the target's prefix
    #            hint (cached pages never cross the wire)
    #   stream   while mid-prefill: gather pages below the progress
    #            mark (page-aligned chunk starts make them FINAL) and
    #            append them as wire chunks
    #   commit   the step loop freezes the slot at its first migratable
    #            boundary (zero extra decode steps on the prefill side);
    #            the handoff loop snapshots the TAIL (from_page = what
    #            already shipped), ships it, and commits with the full
    #            request meta. Outcomes mirror ``migrate_rid``:
    #            commit-ack retires (finish_migrated -> callers chase
    #            the 409 to the decode replica, where the gen key
    #            ADOPTS the restored stream), a definitive refusal
    #            unfreezes and resumes locally (the colocated-degrade
    #            safety net), an ambiguous commit never resumes.

    def _register_handoff_locked(self, rid: int, target: str,
                                 prompt: list,
                                 target_name: Optional[str] = None) -> None:
        """Caller holds ``self._cv`` (the _generate admission branch)."""
        self._handoffs[rid] = {
            "rid": rid,
            "target": target.rstrip("/"),
            "target_name": target_name,
            "state": "begin",
            "prompt": [int(t) for t in prompt],
            # locally-born stream: this handoff is generation 1 of the
            # (this replica, rid) lineage — the target's fence compares
            "tok": {"origin": [self.name, rid], "epoch": 1},
            "epoch": 1,
            # per-ATTEMPT nonce like migrate_rid's: at-most-once lives
            # in the commit fence, not the key
            "kbase": (f"dis-{self.name}-{rid}-e1-"
                      f"{uuid.uuid4().hex[:8]}"),
            "seq": 0,
            "manifest": [],
            "skip": 0,
            # pages CAPTURED off the device (host copies, taken under
            # the step loop's own lock hold so a fast prefill can never
            # outrun the capture) vs pages actually SENT on the wire
            "captured": 0,
            "spans": [],           # [(lo, hi, pages-dict)] awaiting send
            "early_pages": 0,
            "frozen": False,
        }
        self.events.emit("handoff_intent", rid=rid,
                         target=target_name or target)

    def _page_fields(self) -> tuple:
        """Manifest field order for one page span — matches the stored
        pool layout ``snapshot_slot`` ships."""
        return (("k_q", "k_s", "v_q", "v_s")
                if getattr(self.server, "kv_int8", False) else ("k", "v"))

    def _count_handoff(self, result: str) -> None:
        self.server.obs.counter(
            "kubetpu_handoffs_total",
            "disaggregated prefill->decode stream handoffs by outcome",
            result=result).inc()

    def _advance_handoffs_locked(self) -> None:
        """Caller holds ``self._cv`` (the step loop, right after a
        step). Two duties, both cheap enough to ride the loop:

        - CAPTURE newly completed page spans of mid-prefill handoff
          streams (a host copy of a few pages). Riding the step's own
          lock hold makes the pipelining deterministic: a prefill that
          outruns the wire can never outrun the capture, so the spans
          genuinely ship from work completed while later chunks compute
          — the wire sends happen on the handoff loop thread,
          overlapped with the following steps;
        - FREEZE every handoff stream the moment it becomes migratable
          (first token materialized, prefill done), so the prefill
          replica never decodes past the snapshot point."""
        if not self._handoffs:
            return
        progress = getattr(self.server, "prefill_progress", None)
        gather = getattr(self.server, "snapshot_pages", None)
        ps = int(getattr(self.server, "page_size", 0) or 0)
        ready = None
        for rid, h in self._handoffs.items():
            if h["frozen"]:
                continue
            if progress is not None and gather is not None and ps:
                prog = progress(rid)
                if prog is not None:
                    stable = min(prog[0] // ps,
                                 len(h["prompt"]) // ps)
                    if stable > h["captured"]:
                        try:
                            h["spans"].append(
                                (h["captured"], stable,
                                 gather(rid, h["captured"], stable)))
                            h["captured"] = stable
                        except (ValueError, NotImplementedError):
                            pass   # ships with the commit tail instead
                    continue       # mid-prefill: not migratable yet
            if ready is None:
                ready = set(self.server.migratable_rids())
            if rid in ready:
                self.server.freeze_slot(rid)
                h["frozen"] = True

    def _handoff_loop(self) -> None:
        """Drive every in-flight handoff: one bounded action per rid
        per round (a begin POST, one page span's chunks, or the
        tail+commit), rounds fanned over a small worker pool
        (``handoff_workers``) — each action is mostly wire wait, and a
        frozen stream makes no progress ANYWHERE until its commit-ack,
        so serializing N commits costs the Nth stream N x the wire
        latency of dead frozen time. Per-rid ordering is preserved
        (one action per rid per round, rounds joined). Wire work runs
        OUTSIDE the condition — the step loop keeps prefilling other
        slots while bytes move, which is the pipelining."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(
            max_workers=self.handoff_workers,
            thread_name_prefix=f"kubetpu-handoff-{self.name}")
        try:
            while True:
                with self._cv:
                    if not self._running:
                        return
                    rids = list(self._handoffs)
                    if not rids:
                        self._cv.wait(timeout=0.05)
                        continue
                if len(rids) == 1 or self.handoff_workers == 1:
                    # no any()-short-circuit: EVERY rid gets its action
                    progressed = any(
                        [bool(self._handoff_pass_safe(rid))
                         for rid in rids])
                else:
                    # list() BEFORE any(): the round must JOIN — a
                    # short-circuited map iterator would let the next
                    # round start while this round's slow passes still
                    # run, racing two passes of one rid on its chunk
                    # sequence (caught by disagg-check as a
                    # missing-chunk refusal)
                    progressed = any(
                        list(pool.map(self._handoff_pass_safe, rids)))
                if not progressed:
                    with self._cv:
                        if self._running and self._handoffs:
                            self._cv.wait(timeout=0.002)
        finally:
            pool.shutdown(wait=False)

    def _handoff_pass_safe(self, rid: int) -> bool:
        """``_handoff_pass`` with the loop's survival guarantee: ANY
        unexpected exception aborts that one handoff (stream unfrozen,
        resumes locally — the pre-commit failure spelling) instead of
        killing the streamer thread. A dead streamer would be a
        fleet-wide black hole: the step loop keeps freezing every new
        handoff stream at its first token with nothing left to ship,
        commit, or thaw them, while /healthz keeps reporting
        healthy."""
        try:
            return bool(self._handoff_pass(rid))
        except Exception as e:  # noqa: BLE001 — the loop must survive
            with self._cv:
                h = self._handoffs.get(rid)
                if h is not None:
                    self._handoff_abort_locked(
                        rid, h, f"unexpected: {type(e).__name__}: {e}")
            return False

    def _handoff_pass(self, rid: int) -> bool:
        """One bounded action for *rid*'s handoff -> True if anything
        moved (wire bytes or a state transition). Spans captured by the
        step loop drain first (in page order); the commit fires only
        once the stream is frozen AND every captured span is on the
        wire."""
        snap = span = None
        with self._cv:
            h = self._handoffs.get(rid)
            if h is None:
                return False
            if self.server.finished(rid):
                # completed (or canceled) locally before the handoff
                # could commit — a short stream can outrun its own
                # transfer; the caller already has the tokens
                self._handoffs.pop(rid, None)
                self._count_handoff("skipped")
                self.events.emit("handoff_skip", rid=rid,
                                 reason="finished_locally")
                return False
            if h["state"] == "stream":
                if h["spans"]:
                    span = h["spans"].pop(0)
                elif h["frozen"]:
                    try:
                        snap = self.server.snapshot_slot(
                            rid,
                            from_page=max(h["captured"], h["skip"]),
                            allow_frozen=True)
                    except (ValueError, NotImplementedError) as e:
                        return self._handoff_abort_locked(
                            rid, h, f"snapshot: {e}")
        if h["state"] == "begin":
            return self._handoff_begin(rid, h)
        if span is not None:
            return self._handoff_send_span(rid, h, span[0], span[1],
                                           span[2], early=True)
        if snap is not None:
            return self._handoff_commit(rid, h, snap)
        return False

    def _handoff_begin(self, rid: int, h: dict) -> bool:
        """The begin leg: ship the prompt + identity, learn how many
        leading pages the target can map from its own prefix cache —
        those never cross the wire."""
        with self._cv:
            gen_key = self._gen_keys.get(rid)
        meta = {"prompt": h["prompt"], "reason": "disagg",
                "source": self.name}
        if gen_key:
            meta["gen_key"] = gen_key
        try:
            resp = request_json(
                h["target"] + "/migrate_in",
                {"phase": "begin", "token": h["tok"], "meta": meta},
                token=self.token, idempotency_key=h["kbase"] + "-begin",
                timeout=self.migrate_timeout)
        except Exception as e:  # noqa: BLE001 — target dark or refusing
            with self._cv:
                return self._handoff_abort_locked(rid, h,
                                                  f"begin: {e}")
        ps = int(getattr(self.server, "page_size", 1) or 1)
        cap = max(0, (len(h["prompt"]) - 1) // ps)
        h["skip"] = min(max(0, int(resp.get("skip_pages") or 0)), cap)
        h["state"] = "stream"
        self.events.emit("handoff_begin", rid=rid, target=h["target"],
                         skip_pages=h["skip"])
        return True

    def _handoff_send_span(self, rid: int, h: dict, from_page: int,
                           to_page: int, pages: dict,
                           early: bool) -> bool:
        """Append one page span to the transfer: manifest entries in
        field order, bytes as sequenced wire chunks. *early* spans are
        the pipelining — pages captured while later prefill chunks were
        still computing. Pages below the target's prefix hint are
        sliced off (a span captured before the begin answer arrived may
        cover pages the target already holds warm — they never cross
        the wire)."""
        lo = max(from_page, h["skip"])
        if to_page <= lo:
            return True            # entirely covered by the warm hint
        parts = []
        manifest = []
        for field in self._page_fields():
            spec, raw = encode_array(span_name(field, lo),
                                     pages[field][:, lo - from_page:])
            manifest.append(spec)
            parts.append(raw)
        blob = b"".join(parts)
        try:
            for piece in blob_chunks(blob, self.migrate_chunk_bytes):
                request_json(
                    h["target"] + "/migrate_in",
                    {"phase": "chunk", "token": h["tok"],
                     "seq": h["seq"], "data": chunk_b64(piece)},
                    token=self.token,
                    idempotency_key=f"{h['kbase']}-c{h['seq']}",
                    timeout=self.migrate_timeout)
                h["seq"] += 1
        except Exception as e:  # noqa: BLE001 — pre-commit: resume is safe
            with self._cv:
                return self._handoff_abort_locked(rid, h, f"chunk: {e}")
        h["manifest"].extend(manifest)
        with self._cv:
            # plain-int accumulators shared across concurrent handoff
            # workers: += is a read-modify-write, so take the lock
            self._handoff_bytes += len(blob)
            if early:
                self._handoff_early_bytes += len(blob)
        self.server.obs.counter(
            "kubetpu_migration_bytes_shipped_total",
            "snapshot blob bytes shipped over /migrate_in").inc(len(blob))
        if early:
            h["early_pages"] += to_page - lo
            self.server.obs.counter(
                "kubetpu_handoff_pages_streamed_total",
                "KV pages captured+shipped while later prefill chunks "
                "were still computing — the pipelining proof").inc(
                    to_page - lo)
        return True

    def _handoff_commit(self, rid: int, h: dict, snap: dict) -> bool:
        """Ship the tail span + the full request meta, then commit.
        Outcome classification is ``migrate_rid``'s: only a commit-POST
        failure can mask an executed restore — tail-chunk failures
        provably left no live copy (staging is not a stream) and resume
        locally; the commit 200 is the retirement ack."""
        n_live = int(snap["n_live_pages"])
        with self._cv:
            gen_key = self._gen_keys.get(rid)
        meta = {k: v for k, v in snap.items() if k != "pages"}
        meta.update(origin=h["tok"]["origin"], epoch=h["epoch"],
                    gen_key=gen_key, reason="disagg", source=self.name)
        target_label = h.get("target_name") or h["target"]
        with obs_trace.span("disagg.handoff",
                            component=self.obs_component,
                            target=target_label):
            tail_from = max(h["captured"], h["skip"])
            if (n_live > tail_from and not self._handoff_send_span(
                    rid, h, tail_from, n_live, snap["pages"],
                    early=False)):
                return False        # aborted (and unfrozen) inside
            try:
                ack = request_json(
                    h["target"] + "/migrate_in",
                    {"phase": "commit", "token": h["tok"],
                     "n_chunks": h["seq"], "arrays": h["manifest"],
                     "ship_from_page": h["skip"], "meta": meta},
                    token=self.token,
                    idempotency_key=h["kbase"] + "-commit",
                    timeout=self.migrate_timeout)
            except urllib.error.HTTPError as e:
                detail = {}
                try:
                    detail = json.loads(e.read() or b"{}")
                except Exception:  # noqa: BLE001 — body unreadable
                    pass
                if detail.get("fenced"):
                    info = {"replica": detail.get("replica"),
                            "epoch": int(detail.get("epoch", h["epoch"])),
                            "fenced": True}
                    with self._cv:
                        self.server.finish_migrated(rid, info)
                        self._note_stream_left_locked(rid, gen_key, info)
                        self._handoffs.pop(rid, None)
                        self._cv.notify_all()
                    self._count_handoff("fenced")
                    return True
                if e.code < 500:
                    # definitive refusal: the restore raised / staging
                    # gone — resume locally, token-exact (the colocated
                    # degrade)
                    with self._cv:
                        self.server.unfreeze_slot(rid)
                        self._handoffs.pop(rid, None)
                        self._cv.notify_all()
                    self._count_handoff("refused")
                    self.events.emit("handoff_refused", rid=rid,
                                     code=e.code,
                                     error=str(detail.get("error",
                                                          ""))[:120])
                    return True
                return self._handoff_ambiguous(rid, h, gen_key,
                                               f"HTTP {e.code} on commit")
            except Exception as e:  # noqa: BLE001 — transport death
                return self._handoff_ambiguous(rid, h, gen_key, str(e))
            info = {"replica": ack.get("replica"),
                    "rid": ack.get("rid"), "epoch": h["epoch"]}
            with self._cv:
                self.server.finish_migrated(rid, info)
                self._note_stream_left_locked(rid, gen_key, info)
                self._handoffs.pop(rid, None)
                self._cv.notify_all()
            self._count_handoff("committed")
            # emitted INSIDE the span so the event captures the
            # handoff's trace id — disagg-check stitches source and
            # target spans through it
            self.events.emit("handoff_commit", rid=rid,
                             target=ack.get("replica"),
                             epoch=h["epoch"],
                             early_pages=h["early_pages"],
                             pages=n_live - h["skip"])
        return True

    def _handoff_ambiguous(self, rid: int, h: dict,
                           gen_key: Optional[str], err: str) -> bool:
        """A commit whose outcome is unknowable: the target may hold a
        live copy, so the stream finishes as migrated toward it — the
        router retry adopts the restored stream or recomputes fresh
        (at-most-one-active beats resuming here)."""
        info = {"replica": None, "url": h["target"],
                "epoch": h["epoch"], "ambiguous": True}
        with self._cv:
            self.server.finish_migrated(rid, info)
            self._note_stream_left_locked(rid, gen_key, info)
            self._handoffs.pop(rid, None)
            self._cv.notify_all()
        self._count_handoff("ambiguous")
        self.events.emit("handoff_ambiguous", rid=rid, error=err[:120])
        return True

    def _handoff_abort_locked(self, rid: int, h: dict, err) -> bool:
        """Caller holds ``self._cv``. Pre-commit failure: no copy can
        exist at the target (begin/chunk legs only stage), so the
        stream RESUMES here — prefill continues / decode proceeds
        locally, the colocated-degrade safety net."""
        if h.get("frozen"):
            self.server.unfreeze_slot(rid)
        self._handoffs.pop(rid, None)
        self._cv.notify_all()
        self._count_handoff("aborted")
        self.events.emit("handoff_abort", rid=rid, error=str(err)[:120])
        return False

    def _migrate_in(self, req: dict):
        """One phase of the inbound chunked transfer -> (code, obj);
        runs under ``run_idempotent`` (every phase POST is keyed by the
        source, so a lost response replays instead of re-executing)."""
        phase = req.get("phase")
        tok = req.get("token") or {}
        origin = tok.get("origin") or (None, None)
        try:
            key = (str(origin[0]), int(origin[1]), int(tok.get("epoch")))
        except (TypeError, ValueError, IndexError):
            return 400, {"error": "migrate token must carry "
                                  "origin [replica, rid] + epoch"}
        if phase == "begin":
            meta = req.get("meta")
            if not isinstance(meta, dict):
                return 400, {"error": "begin needs a meta object"}
            # prefix NEGOTIATION: advertise how many leading prompt
            # pages this server can map read-only from its own cache —
            # the source ships only the suffix, so matched pages never
            # cross the wire. A hint, not a promise: the commit-time
            # match is re-checked and a receded one refuses.
            skip = 0
            hint = getattr(self.server, "migration_prefix_hint", None)
            if hint is not None and isinstance(meta.get("prompt"), list):
                try:
                    skip = int(hint(meta["prompt"]))
                except Exception:  # noqa: BLE001 — a hint must never
                    skip = 0       # fail a transfer; 0 = ship it all
            with self._cv:
                now = time.monotonic()
                for stale in [k for k, st in self._mig_staging.items()
                              if now - st["ts"] > MIGRATE_STAGING_TTL]:
                    del self._mig_staging[stale]
                self._mig_staging[key] = {"meta": meta, "chunks": {},
                                          "ts": now}
            return 200, {"staged": True, "skip_pages": skip}
        if phase == "chunk":
            seq = req.get("seq")
            try:
                data = chunk_unb64(req.get("data") or "")
            except (ValueError, TypeError):
                return 400, {"error": "chunk data is not base64"}
            with self._cv:
                st = self._mig_staging.get(key)
                if st is None:
                    # definitive: without staging a retry cannot help —
                    # the source resumes the stream locally
                    return 409, {"error": "no staging for this transfer "
                                          "(begin missing or expired)"}
                if not isinstance(seq, int) or seq < 0:
                    return 400, {"error": f"chunk seq {seq!r} invalid"}
                st["chunks"][seq] = data
                st["ts"] = time.monotonic()
            return 200, {"staged": seq}
        if phase == "commit":
            return self._migrate_commit(key, req)
        return 400, {"error": f"unknown migrate phase {phase!r}"}

    def _migrate_commit(self, key: tuple, req: dict):
        """The restore leg: fence the epoch, rebuild the snapshot
        (the commit carries the shipped-array manifest + chunk count —
        they depend on the begin-phase prefix hint, so the source only
        knows them now), resume decode, adopt the generate key. The 200
        here IS the commit-ack the source retires on; it lands in the
        idempotency window, so a retry after a lost ack replays — never
        a second restore (the migrate-check counter assert)."""
        n = req.get("n_chunks")
        arrays = req.get("arrays")
        if not isinstance(n, int) or n < 1 or not isinstance(arrays, list):
            return 400, {"error": "commit needs n_chunks >= 1 + the "
                                  "shipped-array manifest"}
        with self._cv:
            st = self._mig_staging.get(key)
            if st is None:
                return 409, {"error": "no staging for this transfer"}
            missing = [i for i in range(n) if i not in st["chunks"]]
            if missing:
                return 409, {"error": f"transfer incomplete: missing "
                                      f"chunks {missing[:4]}"}
            okey = (key[0], key[1])
            fence = self._mig_epochs.get(okey)
            if fence is not None and key[2] <= fence:
                self.server.obs.counter(
                    "kubetpu_migrations_fenced_total",
                    "stale/duplicate handoff generations refused by "
                    "the epoch fence").inc()
                self.events.emit("migrate_fenced",
                                 origin=f"{okey[0]}/{okey[1]}",
                                 epoch=key[2], fence=fence)
                return 409, {"error": "stale migration epoch",
                             "fenced": True, "replica": self.name,
                             "epoch": fence}
            if self.draining:
                # a draining target would just hand the stream onward;
                # refuse so the source resumes or the policy re-picks
                return 503, {"error": "replica is draining"}
            # the Round-17 streaming handoff only knows the FULL request
            # state at commit time (emitted tokens, position, sampler
            # state all moved while spans streamed), so the commit may
            # carry a meta update that merges over the begin phase's
            extra = req.get("meta") if isinstance(req.get("meta"),
                                                  dict) else {}
            gk = extra.get("gen_key") or st["meta"].get("gen_key")
            if gk and (gk in self._adopted
                       or gk in self._gen_keys.values()):
                # the router already RE-ADMITTED this logical request
                # here (an earlier ambiguous attempt): a restore now
                # would start a second active copy the epoch fence
                # cannot see (a fresh admission carries no origin).
                # Definitive refusal — the source must never resume
                # either (it classified the attempt ambiguous already
                # or will treat this as refused-with-fence-semantics).
                self.server.obs.counter(
                    "kubetpu_migrations_in_total",
                    result="refused").inc()
                return 409, {"error": "stream already active here "
                                      "under this generate key",
                             "fenced": True, "replica": self.name,
                             "epoch": key[2]}
            try:
                blob = b"".join(st["chunks"][i] for i in range(n))
                meta = dict(st["meta"])
                meta.update(extra)
                meta["arrays"] = arrays
                snap = decode_snapshot(meta, blob)
                ship_from = int(req.get("ship_from_page", 0) or 0)
                # a streamed transfer's pages arrive as ordered SPANS
                # (migration.span_name); stitch them back into the
                # contiguous per-field arrays restore_slot consumes —
                # a gap or overlap refuses here, never restores holes
                snap["pages"] = assemble_spans(snap["pages"], ship_from)
                snap["ship_from_page"] = ship_from
                rid = self.server.restore_slot(
                    snap, reason=str(meta.get("reason", "migrate")))
            except (ValueError, NotImplementedError) as e:
                del self._mig_staging[key]
                self.server.obs.counter(
                    "kubetpu_migrations_in_total", result="refused").inc()
                return 400, {"error": f"restore refused: {e}"}
            if rid is None:
                # transient capacity shortfall: the source's keyed retry
                # lands after a slot / pool pages free up
                return 503, {"error": "no capacity for migrated stream"}
            del self._mig_staging[key]
            self._mig_epochs[okey] = key[2]
            # refresh recency: a long-lived frequently-migrating stream
            # must not be the FIRST fence evicted just because its
            # lineage is old (that would re-open the double-restore
            # window the fence closes)
            self._mig_epochs.move_to_end(okey)
            self._trim_locked(self._mig_epochs)
            if gk:
                self._adopted[gk] = rid
                self._trim_locked(self._adopted)
                # the key follows the stream: a FURTHER hop must ship
                # it onward even if no handler ever attaches here
                self._gen_keys[rid] = gk
                self._gc_gen_keys_locked()
                # a stream RETURNING here (A->B->A) must shed the stale
                # migrated-away verdict, or _generate keeps answering
                # 409 with the OLD lower-epoch owner forever
                self._migrated_keys.pop(gk, None)
            self._cv.notify_all()
        self.server.obs.counter(
            "kubetpu_migrations_in_total",
            "inbound migrations by outcome", result="committed").inc()
        return 200, {"rid": rid, "replica": self.name, "epoch": key[2]}

    # -- observability -------------------------------------------------------

    def load(self) -> dict:
        """The routing-signal snapshot: ``server.load_info()`` (host
        counters only — no device sync, no reservoir sort beyond the
        bounded percentile reads) plus this wire layer's flags."""
        info = dict(self.server.load_info())
        info["replica"] = self.name
        info["role"] = self.role
        info["draining"] = self.draining
        info["boot_nonce"] = self.boot_nonce
        # GIL-atomic len reads, like the server's own host counters —
        # the load snapshot is advisory, never a synchronized view
        info["inflight_handoffs"] = len(self._handoffs)
        # staged INBOUND transfers: streams about to land in this
        # pool's slots — the decode-target picker counts them so a
        # burst of handoffs spreads instead of clumping on whichever
        # node's /load snapshot was scraped before the burst
        info["inbound_transfers"] = len(self._mig_staging)
        return info

    def render_events(self, kind: Optional[str] = None,
                      limit: Optional[int] = None) -> str:
        evs = merge_events({
            self.obs_component: self.events,
            "serving": self.server.events,
        }, limit=None)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        if limit is not None and limit >= 0:
            evs = evs[-limit:] if limit else []
        return "".join(json.dumps(e) + "\n" for e in evs)

    # -- step loop -----------------------------------------------------------

    def _poll_loop(self) -> None:
        """Drive the serving object: step while any request is in
        flight, sleep (bounded) while idle. Every touch of the serving
        object happens under the condition — the handlers' enqueue and
        result reads interleave between steps, never during one. The
        drain-timeout check rides the same loop: a bounded drain whose
        deadline passed cancels what's left instead of wedging."""
        try:
            self._step_loop()
        except Exception as e:
            if self._lockstep is None:
                raise
            # a follower is gone or diverged, or a step's collective
            # failed: stop serving, never go on with one rank (handlers
            # answer 503, /healthz 503, shutdown raises)
            with self._cv:
                if self._lockstep.error is None:
                    self._lockstep.error = e
                self._running = False
                self._cv.notify_all()

    def _step_loop(self) -> None:
        ls = self._lockstep
        while True:
            with self._cv:
                if not self._running:
                    return
                self._check_drain_timeout_locked()
                # sleep when a step would advance nothing: idle, OR the
                # only remaining work is frozen mid-handoff (stepping a
                # frozen-only server is a busy no-op spin for the whole
                # wire transfer)
                runnable = getattr(self.server, "_runnable", None)
                if self.server._idle() or (runnable is not None
                                           and not runnable()):
                    # a meshed server's followers take the calls of an
                    # idle tick now, and a tick at least every keepalive
                    if ls is not None and (ls.pending or (
                            time.monotonic() - ls.last_tick
                            >= LOCKSTEP_KEEPALIVE_S)):
                        ls.send("idle")
                    self._cv.wait(timeout=self._idle_wait)
                    continue
                self.server.step()
                # Round-17: capture completed KV spans + pause handoff
                # streams AT the step boundary (the wire work runs on
                # the handoff loop thread, overlapped with later steps)
                self._advance_handoffs_locked()
                self._cv.notify_all()
            # yield OUTSIDE the condition when a KV transfer is in
            # flight (outbound handoffs here / inbound staging on a
            # decode target): a busy step loop re-acquires the lock
            # faster than notified waiters wake, starving the handoff
            # streamer and the transfer handlers for hundreds of
            # milliseconds — one scheduler yield per step lets a parked
            # thread actually take the lock. Transfer-free replicas
            # skip it: the yield costs ~ms of TTFT per admission
            # (pinned by the bench gate's router_ttft_p50_ms ratchet)
            # and buys nothing without a transfer to unblock. A meshed
            # replica yields every step too: its step is a world's
            # collectives, beside which the yield costs nothing, and a
            # handler's enqueue, cancel or timeout must not wait out a
            # whole burst of them.
            if self._handoffs or self._mig_staging or ls is not None:
                time.sleep(0)

    def _check_drain_timeout_locked(self) -> None:
        """Caller holds ``self._cv``. A draining replica past its
        ``drain_timeout_s`` with streams still in flight CANCELS them
        (each expires with reason ``drain_timeout`` — their callers get
        a retryable 503, and retries land elsewhere via the router).
        When a migrate target was named, the migrate loop had the same
        window to move them — the deadline is the hard bound either
        way, so scale-down can never wait out a long-max_tokens
        stream."""
        if (not self.draining or self._drain_deadline is None
                or time.monotonic() < self._drain_deadline
                or self.server._idle()):
            return
        unresolved = False
        for rid in self.server.unfinished_rids():
            if self.server.cancel_expired(rid, "drain_timeout"):
                self.events.emit("drain_timeout", rid=rid)
            elif not self.server.finished(rid):
                # a frozen (mid-handoff) stream refuses cancel — its
                # transfer resolves it; keep the deadline ARMED so the
                # next tick sweeps whatever a refusal resumed
                unresolved = True
        if not unresolved:
            self._drain_deadline = None
        self._cv.notify_all()

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        """Serve + start the step loop (both daemon threads); returns
        the bound address."""
        with self._cv:
            self._running = True
        self._loop_thread = threading.Thread(
            target=self._poll_loop, name=f"kubetpu-replica-{self.name}",
            daemon=True)
        self._loop_thread.start()
        if self.role == "prefill":
            self._handoff_thread = threading.Thread(
                target=self._handoff_loop,
                name=f"kubetpu-replica-handoff-{self.name}", daemon=True)
            self._handoff_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"kubetpu-replica-http-{self.name}", daemon=True)
        self._thread.start()
        return self.address

    def drain(self, migrate_to: Optional[str] = None,
              reason: str = "drain") -> None:
        """Refuse NEW generates (503); admitted and handler-waiting
        requests run to completion — the step loop keeps stepping until
        the server goes idle. With *migrate_to*, in-flight streams are
        HANDED OFF live to that replica instead (token-exact; their
        callers learn the new owner via 409) — the drain completes as
        fast as the wire, not as slow as the longest stream.
        ``drain_timeout_s`` arms the cancel backstop either way."""
        with self._cv:
            if not self.draining:
                self.events.emit("drain", replica=self.name,
                                 reason=reason)
            self.draining = True
            if migrate_to:
                self._drain_migrate = migrate_to.rstrip("/")
            if (self.drain_timeout_s is not None
                    and self._drain_deadline is None):
                self._drain_deadline = (time.monotonic()
                                        + self.drain_timeout_s)
            if (self._drain_migrate is not None
                    and (self._drain_thread is None
                         or not self._drain_thread.is_alive())):
                # created AND started under the cv: two racing drain
                # POSTs must never both .start() one Thread object
                # (start() returns before the target body needs the cv)
                self._drain_thread = threading.Thread(
                    target=self._drain_migrate_loop,
                    args=(self._drain_migrate, reason),
                    name=f"kubetpu-replica-drain-migrate-{self.name}",
                    daemon=True)
                self._drain_thread.start()
            self._cv.notify_all()

    def _drain_migrate_loop(self, target_url: str, reason: str) -> None:
        """Hand every in-flight stream to the drain's migrate target
        until this replica is idle. Loops because queued requests
        surface as migratable only once freed slots admit them and
        their first token lands; bounded so a target refusing
        everything cannot spin forever (the drain-timeout cancel is the
        final word). The target is RE-READ each pass: a re-issued drain
        naming a different target (the first one died) must redirect
        the remaining streams, not keep shipping to a corpse."""
        deadline = time.monotonic() + max(
            30.0, 2.0 * (self.drain_timeout_s or 0.0))
        while time.monotonic() < deadline:
            with self._cv:
                if not self._running or self.server._idle():
                    return
                pending = bool(self.server.migratable_rids())
                target_url = self._drain_migrate or target_url
            if not pending:
                time.sleep(0.01)
                continue
            done, failed = self.migrate_all(target_url, reason=reason)
            # nothing committed (an unmigratable server, or a target
            # refusing everything): back off instead of spamming
            # per-stream attempts every couple of milliseconds — the
            # drain-timeout cancel remains the hard bound
            time.sleep(0.25 if done == 0 and failed else 0.002)

    def shutdown(self, graceful: bool = True, timeout: float = 10.0) -> None:
        """Stop the server. ``graceful`` drains, waits (bounded) for the
        serving object to go idle and for in-flight HTTP requests to
        finish; False simulates abrupt death (chaos tests). A meshed
        replica whose lockstep failed skips the wait (nothing can finish)
        and raises ``LockstepError`` once stopped."""
        if graceful and not self.lockstep_failed():
            self.drain()
            deadline = time.monotonic() + timeout
            with self._cv:
                while (not self.server._idle()
                       and time.monotonic() < deadline):
                    self._cv.wait(timeout=0.05)
            self._inflight.wait_idle(timeout)
        with self._cv:
            self._running = False
            drain_thread, self._drain_thread = self._drain_thread, None
            self._cv.notify_all()
        if drain_thread is not None:
            drain_thread.join(timeout=5.0)
        if self._handoff_thread is not None:
            self._handoff_thread.join(timeout=5.0)
            self._handoff_thread = None
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
            self._loop_thread = None
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        ls = self._lockstep
        if ls is not None:
            with self._cv:
                if ls.error is None and not ls.stopped:
                    ls.send("stop")      # the followers' loops return
            if ls.error is not None:
                raise LockstepError(
                    f"replica {self.name}: a follower rank failed: "
                    f"{ls.error}") from ls.error

    def lockstep_failed(self) -> bool:
        """A meshed replica whose follower died or diverged: it serves
        nothing more (``/healthz`` answers 503)."""
        return self._lockstep is not None and self._lockstep.error is not None

    def lockstep_stats(self) -> Optional[dict]:
        """A meshed replica's ticks by verb, calls and bytes broadcast to
        its followers (None for a one-device server)."""
        return None if self._lockstep is None else self._lockstep.stats()


# -- a meshed server behind the wire ------------------------------------------
#
# A meshed server (``server.mesh`` not None) is SPMD: one process a rank,
# every rank holding the same host scheduler and taking part in each
# step's collectives, so every rank must receive the same calls in the
# same order. Rank 0 of the mesh serves the wire (``ReplicaServer``); the
# other ranks run ``follow_replica``. Rank 0 touches its server through
# ``_RecordedServer``: each call that changes what ``check_lockstep``
# digests, or that runs a collective, is appended to a call log, and the
# log reaches the followers over a gloo group of the whole mesh (a CPU
# group even where the model's tensors ride NCCL) before rank 0 runs the
# call (a "call" tick, so every rank enters a call's collectives
# together) and at each tick of rank 0's step loop, with the tick's verb:
# step, idle or stop. A follower applies the calls in rank 0's order,
# then steps, idles or returns. Every call's outcome (its plain result,
# or the exception it raised) follows it in the log and each follower
# checks its own against it: a follower that diverges raises, and
# its death fails rank 0's next broadcast, which stops the replica (503s,
# ``/healthz`` not ok, ``shutdown`` raises). No follower reads a clock:
# the idle decision, the drain deadline and the generate timeouts are rank
# 0's, and reach the others as verbs and calls.

# calls that change the digested host state or run a collective
RECORDED = frozenset((
    "enqueue", "cancel", "cancel_expired", "pop_result", "freeze_slot",
    "unfreeze_slot", "finish_migrated", "snapshot_slot", "snapshot_pages",
    "restore_slot", "load_adapter", "evict_adapter", "export_prefix_span",
    "inject_prefix", "prefix_local_pages", "migration_prefix_hint"))
# a tick's frame: 8 bytes of length, then the first of the pickled log;
# a longer log follows in a second broadcast
LOCKSTEP_FRAME = 4096
# an idle rank 0 still ticks this often, so a dead follower is seen
LOCKSTEP_KEEPALIVE_S = 1.0
# a follower waits this long for a tick before its broadcast raises
LOCKSTEP_TIMEOUT_S = 300.0


class LockstepError(RuntimeError):
    """A follower's call came out unlike rank 0's, or the log's broadcast
    failed: the mesh's ranks no longer hold the same server."""


def _plain(x):
    """What of a call's result every rank must agree on: plain values
    (nested in lists, tuples and dicts) as they are, anything else (an
    array, a tensor) by its type's name."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    return type(x).__name__


def _mesh_ranks(mesh) -> list:
    return sorted(int(r) for r in mesh.mesh.flatten().tolist())


class _Lockstep:
    """The call log of one meshed server, on each rank: rank 0 records and
    sends, the followers receive and apply. Joining builds a gloo group of
    the whole world (a collective: rank 0's ``ReplicaServer`` and every
    follower's ``follow_replica`` join at the same point of the program)."""

    def __init__(self, server) -> None:
        import datetime

        import torch.distributed as dist

        ranks = _mesh_ranks(server.mesh)
        if ranks != list(range(dist.get_world_size())):
            raise ValueError(
                f"a meshed replica's mesh must span the process group "
                f"(mesh ranks {ranks}, world {dist.get_world_size()})")
        self.dist = dist
        self.src = ranks[0]
        self.group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=LOCKSTEP_TIMEOUT_S))
        self.pending: list = []
        self.last = None            # a follower's latest call outcome
        self.last_name = None       # and that call's name
        self.stopped = False
        self.error: Optional[BaseException] = None
        self.last_tick = time.monotonic() if self.leader else None
        self.ticks = {"step": 0, "idle": 0, "call": 0, "stop": 0}
        self.calls = 0
        self.bytes = 0

    @property
    def leader(self) -> bool:
        return self.dist.get_rank() == self.src

    def stats(self) -> dict:
        """Ticks by verb, calls carried and bytes broadcast so far."""
        return {"ticks": dict(self.ticks), "calls": self.calls,
                "bytes": self.bytes}

    # -- rank 0 --------------------------------------------------------------

    def send(self, verb: str) -> None:
        """Broadcast the pending log with *verb*; caller holds the
        replica's condition. A failed broadcast stops the lockstep for
        good: every later call raises."""
        import pickle

        import numpy as np
        import torch

        if self.error is not None:
            raise LockstepError(f"lockstep failed: {self.error}")
        if self.stopped:
            raise LockstepError("lockstep stopped")
        calls, self.pending = self.pending, []
        blob = pickle.dumps((verb, calls), protocol=pickle.HIGHEST_PROTOCOL)
        n = len(blob)
        head = np.zeros(LOCKSTEP_FRAME, np.uint8)
        head[:8] = np.frombuffer(n.to_bytes(8, "little"), np.uint8)
        first = min(n, LOCKSTEP_FRAME - 8)
        head[8:8 + first] = np.frombuffer(blob[:first], np.uint8)
        try:
            self.dist.broadcast(torch.from_numpy(head), self.src,
                                group=self.group)
            if n > first:
                self.dist.broadcast(torch.from_numpy(
                    np.frombuffer(blob[first:], np.uint8).copy()),
                    self.src, group=self.group)
        except Exception as e:  # noqa: BLE001 — a peer is gone
            self.error = e
            raise LockstepError(f"lockstep broadcast failed: {e}") from e
        self.ticks[verb] += 1
        self.calls += sum(1 for c in calls if c[0] != "=")
        self.bytes += LOCKSTEP_FRAME + max(0, n - first)
        self.last_tick = time.monotonic()
        if verb == "stop":
            self.stopped = True

    def call(self, cv, name: str, fn, args: tuple, kwargs: dict):
        """Run recorded call *name* on rank 0 and log it (with its
        outcome) for the followers."""
        with cv:
            if self.error is not None or self.stopped:
                raise LockstepError(
                    f"lockstep {'failed' if self.error else 'stopped'}: "
                    f"{name} refused")
            self.pending.append([name, args, kwargs])
            self.send("call")
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                outcome = ("raise", type(e).__name__)
                raise
            else:
                outcome = ("ok", _plain(out))
                return out
            finally:
                self.pending.append(["=", outcome])

    # -- the followers -------------------------------------------------------

    def receive(self) -> tuple:
        import pickle

        import numpy as np
        import torch

        head = torch.empty(LOCKSTEP_FRAME, dtype=torch.uint8)
        self.dist.broadcast(head, self.src, group=self.group)
        raw = head.numpy()
        n = int.from_bytes(raw[:8].tobytes(), "little")
        first = min(n, LOCKSTEP_FRAME - 8)
        blob = raw[8:8 + first].tobytes()
        if n > first:
            rest = torch.empty(n - first, dtype=torch.uint8)
            self.dist.broadcast(rest, self.src, group=self.group)
            blob += rest.numpy().tobytes()
        self.bytes += LOCKSTEP_FRAME + max(0, n - first)
        return pickle.loads(blob)

    def apply(self, server, calls: list) -> None:
        """Apply rank 0's calls in its order, each outcome (the "=" entry
        that follows its call, in the same tick or a later one) held
        against rank 0's."""
        for entry in calls:
            if entry[0] == "=":
                if self.last != entry[1]:
                    raise LockstepError(
                        f"rank {self.dist.get_rank()}: {self.last_name} gave "
                        f"{str(self.last)[:200]}, rank 0 "
                        f"{str(entry[1])[:200]}")
                continue
            name, args, kwargs = entry
            if name not in RECORDED:
                raise LockstepError(f"call {name!r} is not recorded")
            self.calls += 1
            self.last_name = name
            try:
                self.last = ("ok", _plain(getattr(server, name)(
                    *args, **kwargs)))
            except Exception as e:  # noqa: BLE001 — compared at its "="
                self.last = ("raise", type(e).__name__)

class _RecordedServer:
    """Rank 0's view of a meshed server: reads pass through; each recorded
    call goes through the call log; ``step`` ticks the followers first."""

    def __init__(self, server, lockstep: _Lockstep, cv) -> None:
        self._server = server
        self._lockstep = lockstep
        self._cv = cv

    def __getattr__(self, name):
        attr = getattr(self._server, name)
        if name not in RECORDED or not callable(attr):
            return attr

        def recorded(*args, **kwargs):
            return self._lockstep.call(self._cv, name, attr, args, kwargs)

        return recorded

    def step(self):
        with self._cv:
            self._lockstep.send("step")
            return self._server.step()


def follow_replica(server) -> dict:
    """A follower rank of a meshed server behind the wire: the step loop
    of rank 0's ``ReplicaServer`` (on the mesh's first rank, built at the
    same point of the program) without a socket. Receives each tick's
    calls, applies them in rank 0's order, then steps, idles, or returns
    at stop -> the ticks by verb, the calls applied and the bytes
    received. Raises ``LockstepError`` where a call comes out unlike rank
    0's; a failed broadcast raises too. Rank 0 serves, the rest follow::

        if rank == 0:
            rep = ReplicaServer(server, "r0"); rep.start(); ...
            rep.shutdown()
        else:
            follow_replica(server)
    """
    if getattr(server, "mesh", None) is None:
        raise ValueError("follow_replica takes a meshed server (mesh=)")
    ls = _Lockstep(server)
    if ls.leader:
        raise ValueError("the mesh's first rank serves (ReplicaServer); "
                         "only the other ranks follow")
    while True:
        verb, calls = ls.receive()
        ls.ticks[verb] += 1
        ls.apply(server, calls)
        if verb == "step":
            server.step()
        elif verb == "stop":
            return ls.stats()
