"""``RouterServer`` — the prefix-affinity data plane in front of N
serving replicas (port of ``kubetpu/router/server.py``; stdlib plus the
port's ``obs`` and ``wire``, no torch).

The millions-of-users story: every ``PagedDecodeServer`` replica
has a radix tree, but without a router each replica gets
per-replica cache luck and load that ignores capacity. This server
makes cluster-wide decisions per request:

1. **affinity routing**: the tokenized prefix HEAD (first
   ``head_tokens`` ids) consistent-hashes onto the replica ring
   (``hashring``), so requests sharing a system prompt / few-shot
   preamble land where that prefix's KV pages are already warm —
   cluster-wide hit rate instead of luck. ``policy="random"`` is the
   seeded baseline the router storm benches against;
2. **load fallback**: the affinity target is skipped when its last
   ``/load`` snapshot reads overloaded (queue depth at/over
   ``overload_queue_depth``, or paged free pages under
   ``min_free_pages``) — the walk continues down the key's
   deterministic preference order, ending at the least-queued routable
   replica when everyone is busy. Snapshots come from the pool's
   throttled concurrent refresh, never a per-request scrape;
3. **SLO-class admission**: with objectives declared
   (``obs.slo.router_slos`` over the router's FEDERATED /metrics —
   worst-replica percentiles, exactly what the controller does), a
   burning fast window sheds ``shed_classes`` requests (503, counted)
   and parks ``queue_classes`` requests (bounded wait for the burn to
   clear, then 503) while interactive traffic keeps flowing.

Surfaces::

    POST   /generate         {"prompt": [ids], "slo_class"?, "sampling"?,
                              "timeout"?} -> routed reply + "replica"
    POST   /replicas         {"url": ...} -> register (idempotent by URL)
    DELETE /replicas/<name>  forget a replica (drain first — see
                              ``ReplicaAutoscaler`` for the safe order)
    GET    /replicas         pool listing (state, draining, last load)
    GET    /healthz /metrics /slo /events /trace/<id>

``/metrics`` federates every replica's exposition under
``replica="<name>"``; ``/trace/<id>`` stitches the router span with the
replica legs, so one generate renders router -> replica -> serving in
``kubetpu.cli.obs --trace``.

Robustness is the wire stack's uniform contract: the router -> replica leg is
a keyed ``request_json`` POST (retries can never double-admit — the
replica replays its committed tokens), the router's own ``/generate``
honors client ``Idempotency-Key`` headers through the same
``run_idempotent`` dance, and ``faults=`` injects chaos on the router
surface itself. The router holds NO model state — it can restart (or
run replicated) with zero warmup; two routers agree on every routing
key because the ring is seedless ``hashlib``.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import uuid
from collections import Counter, OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from kubetpu_torch.api import utils
from kubetpu_torch.core.metrics import LatencyRecorder
from kubetpu_torch.obs import trace as obs_trace
from kubetpu_torch.obs.events import EventLog
from kubetpu_torch.obs.registry import Registry, install_process_gauges
from kubetpu_torch.obs.slo import Objective, SloEngine
from kubetpu_torch.router.hashring import DEFAULT_HEAD_QUANTUM, \
    DEFAULT_HEAD_TOKENS, HashRing, prefix_head_key
from kubetpu_torch.router.pool import (HEALTHY, SUSPECT, ReplicaPool,
                                 role_compatible)
from kubetpu_torch.wire.httpcommon import (
    IdempotencyCache,
    InflightTracker,
    TRANSIENT_ERRORS,
    check_bearer,
    handle_guarded,
    request_json,
    run_idempotent,
    serve_events_jsonl,
    write_json,
    write_text,
)

DEFAULT_ROUTE_TIMEOUT = 30.0


class RouterServer:
    """Prefix-affinity request router + replica pool owner."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        token: "str | None" = None,
        faults=None,
        policy: str = "affinity",
        head_tokens: int = DEFAULT_HEAD_TOKENS,
        head_quantum: int = DEFAULT_HEAD_QUANTUM,
        vnodes: int = 64,
        overload_queue_depth: int = 4,
        min_free_pages: int = 0,
        load_refresh_s: float = 0.25,
        slos: Optional[List[Objective]] = None,
        slo_interval_s: float = 0.5,
        shed_classes: Tuple[str, ...] = ("batch",),
        queue_classes: Tuple[str, ...] = ("standard",),
        queue_timeout_s: float = 2.0,
        tenant_slo_classes: Optional[Dict[str, str]] = None,
        adapters=None,
        idem_window: float = 300.0,
        suspect_after: int = 2,
        dead_after: int = 5,
        probation_passes: int = 2,
        seed: int = 0,
        **engine_kw,
    ) -> None:
        if policy not in ("affinity", "random"):
            raise ValueError("policy must be 'affinity' or 'random'")
        self.policy = policy
        self.token = token or None
        self.faults = faults
        self.head_tokens = int(head_tokens)
        self.head_quantum = int(head_quantum)
        self.overload_queue_depth = int(overload_queue_depth)
        self.min_free_pages = int(min_free_pages)
        self.load_refresh_s = float(load_refresh_s)
        self.shed_classes = tuple(shed_classes)
        self.queue_classes = tuple(queue_classes)
        self.queue_timeout_s = float(queue_timeout_s)
        # multi-tenant control plane: per-tenant SLO classes
        # (adapter name -> class; a request naming an adapter but no
        # slo_class inherits its tenant's) and an optional
        # AdapterRegistry (the content-hashed source of truth behind
        # POST /adapters distribution)
        self.tenant_slo_classes = dict(tenant_slo_classes or {})
        self.adapters = adapters
        self.obs_component = "router"
        self.registry = Registry()
        install_process_gauges(self.registry, "router")
        self.events = EventLog(component="router")
        self.pool = ReplicaPool(
            token=token, suspect_after=suspect_after, dead_after=dead_after,
            probation_passes=probation_passes, registry=self.registry,
            events=self.events)
        self.ring = HashRing(vnodes=vnodes)
        self.idem = IdempotencyCache(ttl=idem_window)
        self._inflight = InflightTracker()
        self._lock = threading.Lock()       # ring membership + throttles
        self._rng = random.Random(seed)     # the "random" baseline policy
        self._last_slo_eval = 0.0
        self._metrics = LatencyRecorder(
            registry=self.registry, metric="kubetpu_router_latency_seconds")
        self._c_routed = self.registry.counter(
            "kubetpu_router_requests_total", outcome="routed")
        self._c_shed = self.registry.counter(
            "kubetpu_router_requests_total", outcome="shed")
        self._c_qtimeout = self.registry.counter(
            "kubetpu_router_requests_total", outcome="queue_timeout")
        self._c_norep = self.registry.counter(
            "kubetpu_router_requests_total", outcome="no_replica")
        self._c_uperr = self.registry.counter(
            "kubetpu_router_requests_total", outcome="upstream_error")
        self._c_fallback = self.registry.counter(
            "kubetpu_router_fallback_total",
            "requests whose affinity target was skipped for load/health")
        self._c_queued = self.registry.counter(
            "kubetpu_router_queued_total",
            "requests parked by SLO-class admission while burning")
        self._c_tenant_affine = self.registry.counter(
            "kubetpu_router_tenant_affine_total",
            "routing decisions narrowed to replicas advertising the "
            "request's adapter resident")
        # -- live migration: the mid-stream rid -> replica
        # RE-PIN map. A source replica answering 409-migrated names the
        # new owner; the pin (keyed by the request's downstream
        # idempotency key, epoch-fenced so a stale notice can't repoint
        # a later handoff) makes this attempt — and any client retry of
        # the same logical request — land on the new owner instead of
        # re-running affinity against a replica that no longer holds
        # the stream.
        self._pins: "OrderedDict[str, Tuple[Optional[str], int]]" = \
            OrderedDict()
        self._suspect_handled: set = set()
        self._decode_rr = 0          # round-robin decode-target ties
        # recent decode-target handouts: (monotonic ts, name). The
        # /load snapshots are throttled, so a burst of admissions
        # inside one refresh window would all read the same "emptiest"
        # node — the router charges its own recent assignments on top
        # of the stale snapshot until the next scrape can see them.
        self._recent_decode: "deque" = deque()
        self._c_repin = self.registry.counter(
            "kubetpu_router_repins_total",
            "mid-stream rid->replica re-pins after a 409-migrated "
            "answer")
        self._c_migrate_away = self.registry.counter(
            "kubetpu_router_migrate_away_total",
            "breaker-suspect migrate-away sweeps requested")
        self._c_restart_unpins = self.registry.counter(
            "kubetpu_router_restart_unpins_total",
            "mid-stream pins dropped because their owner replica came "
            "back with a new boot nonce")
        # a replica that returns with a NEW boot nonce was
        # hard-killed — its slot table, KV pages, and stream epochs are
        # gone, so any pin naming it points at state that no longer
        # exists. Drop those pins so the keyed client retries re-enter
        # the normal route path and land on a survivor (or the fresh
        # boot); the idempotency key plus epoch fencing make the
        # re-drive safe to replay.
        self.pool.on_restart(self._on_replica_restart)
        self.registry.gauge_fn("kubetpu_router_burning",
                               lambda: 1.0 if self._burning() else 0.0)
        # SLO engine over the FEDERATED scrape (worst replica judged) —
        # evaluated on the background signals loop (throttled to
        # slo_interval_s) and per autoscaler pass; handlers only read
        self.slo: Optional[SloEngine] = (
            SloEngine(slos, registry=self.registry, **engine_kw)
            if slos else None)
        self._slo_interval = float(slo_interval_s)
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
                utils.logf(5, "router: " + fmt, *args)

            def _authorized(self) -> bool:
                if check_bearer(self.headers, router.token):
                    return True
                write_json(self, 401,
                           {"error": "missing or invalid bearer token"})
                return False

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):  # noqa: N802
                handle_guarded(router, self, self._do_get)

            def _do_get(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    write_json(self, 200, {
                        "ok": True,
                        "component": "router",
                        "replicas": len(router.pool.names()),
                    })
                elif not self._authorized():
                    pass  # 401 already sent
                elif path == "/metrics":
                    write_text(self, 200, router.metrics_text())
                elif path == "/slo":
                    write_json(self, 200, {
                        "results": (router.slo.results()
                                    if router.slo is not None else {}),
                        "burning": router._burning(),
                    })
                elif path == "/events":
                    serve_events_jsonl(self, router.events.to_jsonl)
                elif path == "/replicas":
                    write_json(self, 200,
                               {"replicas": router.pool.to_json()})
                elif path == "/adapters":
                    write_json(self, 200, router.adapter_summary())
                elif path.startswith("/trace/"):
                    write_json(self, 200,
                               router.trace(path[len("/trace/"):]))
                else:
                    write_json(self, 404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                handle_guarded(router, self, self._do_post)

            def _do_post(self):
                if not self._authorized():
                    return
                if self.path == "/replicas":
                    try:
                        req = self._body()
                        name = router.register_replica(
                            req["url"], name=req.get("name"),
                            role=req.get("role"))
                        write_json(self, 200, {"replica": name})
                    except ValueError as e:
                        # name conflict: the caller's mistake, not an
                        # unreachable replica — 409, never a silent swap
                        write_json(self, 409, {"error": str(e)})
                    except Exception as e:  # noqa: BLE001 — report
                        write_json(self, 502,
                                   {"error": f"registration failed: {e}"})
                    return
                if self.path == "/adapters":
                    try:
                        req = self._body()
                    except ValueError:
                        write_json(self, 400,
                                   {"error": "body is not JSON"})
                        return
                    write_json(self, *router._adapters_post(req))
                    return
                if self.path != "/generate":
                    write_json(self, 404, {"error": f"no route {self.path}"})
                    return
                try:
                    req = self._body()
                except ValueError:
                    write_json(self, 400, {"error": "body is not JSON"})
                    return
                key = self.headers.get("Idempotency-Key")
                run_idempotent(
                    self, router.idem, key,
                    lambda: router._route_request(req, client_key=key),
                )

            def do_DELETE(self):  # noqa: N802
                handle_guarded(router, self, self._do_delete)

            def _do_delete(self):
                if not self._authorized():
                    return
                if self.path.startswith("/replicas/"):
                    name = self.path[len("/replicas/"):]
                    if router.remove_replica(name):
                        write_json(self, 200, {"removed": name})
                    else:
                        write_json(self, 404,
                                   {"error": f"no replica {name!r}"})
                else:
                    write_json(self, 404, {"error": f"no route {self.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- membership ----------------------------------------------------------

    def register_replica(self, url: str, name: Optional[str] = None,
                         role: Optional[str] = None) -> str:
        """Register a replica and give it ring arcs. Idempotent at the
        same URL. Ring membership changes ONLY here and in
        ``remove_replica`` — transient health blips cordon via the
        breaker without remapping anyone's prefix buckets.
        DECODE-only replicas get NO ring arcs — prompts never route to
        them by affinity (they receive streams over the handoff wire),
        so their arcs would only manufacture fallbacks."""
        name = self.pool.add(url, name=name, role=role)
        # seed a load snapshot FIRST: besides giving the first routed
        # request a view of the newcomer, the /load body resolves the
        # ROLE for explicit-name registrations (probe-free in the
        # pool), and the ring-arc decision below must see it
        self.pool.refresh(0.0)
        if self.pool.role(name) != "decode":
            with self._lock:
                self.ring.add(name)
        return name

    def remove_replica(self, name: str) -> bool:
        with self._lock:
            self.ring.remove(name)
        return self.pool.remove(name)

    # -- routing -------------------------------------------------------------

    def _overloaded(self, load: Optional[dict]) -> bool:
        if load is None:
            return False             # no snapshot yet: don't exile it
        if int(load.get("queue_depth", 0)) >= self.overload_queue_depth:
            return True
        free = load.get("pages_free")
        return free is not None and int(free) < self.min_free_pages

    def _pick(self, prompt: List[int],
              adapter=None) -> Tuple[Optional[str], bool]:
        """(replica name, was_affinity_target) — the routing decision.
        Affinity: walk the key's preference order, skipping unroutable
        and overloaded replicas; everyone overloaded -> least-queued
        routable. Random policy: seeded uniform choice (the bench
        baseline). Fresh prompts route only to PREFILL-capable
        replicas (role prefill/both) — decode workers receive their
        streams over the handoff wire, not the prompt path. A fleet
        with nothing prefill-capable (a misconfiguration) degrades to
        routing anywhere rather than going dark. A request
        naming an *adapter* narrows to TENANT-AFFINE replicas — those
        whose last /load snapshot advertises the adapter resident
        (``resident_adapters``) — so a tenant's requests land where
        their factors (and their salted prefix pages) already live; no
        replica advertising it degrades to the normal walk (the landing
        replica answers 400 unless the adapter is pushed, or the
        request named a stack index)."""
        routable = set(self.pool.routable())
        capable = {n for n in routable
                   if self.pool.role(n) != "decode"}
        if capable:
            routable = capable
        if adapter is not None:
            affine = {
                n for n in routable
                if str(adapter) in ((self.pool.snapshot(n) or {})
                                    .get("resident_adapters") or ())}
            if affine:
                if affine != routable:
                    self._c_tenant_affine.inc()
                routable = affine
        if not routable:
            return None, False
        with self._lock:
            if self.policy == "random":
                return self._rng.choice(sorted(routable)), False
            prefs = self.ring.preference(prefix_head_key(
                prompt, self.head_tokens, self.head_quantum))
        if not prefs:
            return None, False
        # the TRUE affinity target is the unfiltered ring head: landing
        # anywhere else — because the target is cordoned, draining OR
        # overloaded — is a fallback, and the metric must say so
        target = prefs[0]
        prefs = [n for n in prefs if n in routable]
        if not prefs:
            return None, False
        for name in prefs:
            if not self._overloaded(self.pool.snapshot(name)):
                if name != target:
                    self._c_fallback.inc()
                return name, name == target
        # everyone overloaded: least-queued routable still gets the work
        # (the SLO-class gate, not the picker, is the shed decision)
        def depth(n):
            load = self.pool.snapshot(n) or {}
            return int(load.get("queue_depth", 0))

        name = min(prefs, key=depth)
        if name != target:
            self._c_fallback.inc()
        return name, name == target

    def _pick_decode(self, exclude=()) -> Optional[str]:
        """The DECODE-pool placement decision: where a
        prefill replica should stream a prompt's KV, chosen at
        admission from the decode pool's load — dedicated decode
        replicas first, then colocated ``both`` nodes; within a tier
        the fewest active slots, then the most free pool pages (the
        page floor is the decode pool's real capacity). None when no
        decode-capable replica is routable — the prefill replica then
        serves the stream itself (colocated degrade)."""
        cands = sorted(n for n in self.pool.routable()
                       if n not in exclude
                       and self.pool.role(n) != "prefill")
        if not cands:
            return None
        now = time.monotonic()
        horizon = max(2.0 * self.load_refresh_s, 0.25)
        with self._lock:
            while (self._recent_decode
                   and now - self._recent_decode[0][0] > horizon):
                self._recent_decode.popleft()
            recent = Counter(n for _t, n in self._recent_decode)
            self._decode_rr += 1
            rot = self._decode_rr % len(cands)

        def key(n):
            load = self.pool.snapshot(n) or {}
            free = load.get("pages_free")
            # occupancy = the stale snapshot PLUS this router's own
            # handouts since (inbound transfers + recent assignments):
            # a burst of admissions inside one refresh window must
            # spread, not clump on whichever node was scraped emptiest
            return (0 if self.pool.role(n) == "decode" else 1,
                    int(load.get("active_slots", 0))
                    + int(load.get("queue_depth", 0))
                    + int(load.get("inbound_transfers", 0))
                    + recent[n],
                    -(int(free) if free is not None else 1 << 30))

        # rotate before the (stable) min so residual LOAD TIES break
        # round-robin across admissions instead of always on the first
        # name
        pick = min(cands[rot:] + cands[:rot], key=key)
        with self._lock:
            self._recent_decode.append((now, pick))
        return pick

    def _prefix_peer(self, prompt: List[int],
                     exclude: str) -> Optional[str]:
        """The cross-replica prefix tier's peer hint: the
        first replica in this prompt's ring preference order that is
        routable and not *exclude* — where the affinity policy sent (or
        would have sent) this family's earlier traffic. None under the
        random policy (no affinity structure to exploit) or a
        one-replica fleet."""
        routable = set(self.pool.routable())
        routable.discard(exclude)
        if not routable:
            return None
        with self._lock:
            if self.policy == "random":
                return None
            prefs = self.ring.preference(prefix_head_key(
                prompt, self.head_tokens, self.head_quantum))
        for n in prefs:
            if n in routable:
                return n
        return None

    def _route_request(self, req: dict, client_key: Optional[str] = None):
        """One routed generate -> (code, obj); runs under
        ``run_idempotent`` on the handler thread."""
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return 400, {"error": "prompt must be a non-empty list of "
                                  "token ids"}
        adapter = req.get("adapter")
        # per-tenant SLO classes: a request naming an adapter
        # but no explicit class inherits its tenant's declared class —
        # an explicit slo_class always wins (the operator's override)
        slo_class = req.get("slo_class")
        if slo_class is None and adapter is not None:
            slo_class = self.tenant_slo_classes.get(str(adapter))
        slo_class = str(slo_class or "interactive")
        deadline = time.monotonic() + float(
            req.get("timeout") or DEFAULT_ROUTE_TIMEOUT)
        code, obj = self._admit(slo_class)
        if code is not None:
            return code, obj
        # route timing starts AFTER the admission gate: a queue-parked
        # request's park time is already recorded as queue_wait, and
        # folding it into op=route would make route_p99 judge the
        # gate's own delay — the gate re-triggering itself after the
        # original burn cleared
        t0 = time.perf_counter()
        # up to two candidates: the picked replica, and — when the POST
        # itself fails (it started draining / died between the snapshot
        # and now) — one fresh pick with the pool's updated view. ONE
        # idempotency key covers the whole logical request — derived
        # from the CLIENT's key when it sent one, so even a client-level
        # retry of a keyed request reuses the same downstream key: any
        # re-execution that lands the same replica after an ambiguous
        # failure (admitted, response lost past the retry budget)
        # REPLAYS the committed tokens instead of admitting twice. The
        # residual window is a re-pick landing a DIFFERENT replica —
        # transient double compute that retires and frees its pages,
        # bounded by per-replica dedup being the only state a jax-free
        # router can carry.
        leg_key = ("router-gen-" + (client_key or uuid.uuid4().hex))
        last_err: Optional[str] = None
        # attempts: the affinity pick, one failover re-pick, plus
        # several migrated-stream re-pins — a request must be able to
        # CHASE a stream that hops more than once (drain chains, the
        # migrate-check ping-pong) before its budget gives up
        for attempt in range(6):
            pinned = self._pinned_replica(leg_key)
            if pinned is not None:
                name, affinity = pinned, False
            else:
                name, affinity = self._pick(prompt, adapter=adapter)
            if name is None:
                self._c_norep.inc()
                return 503, {"error": "no routable replica"}
            url = self.pool.url(name)
            if url is None:
                self._unpin(leg_key)
                continue
            payload = {"prompt": prompt,
                       "timeout": max(0.1, deadline - time.monotonic())}
            if req.get("sampling") is not None:
                payload["sampling"] = req["sampling"]
            if adapter is not None:
                payload["adapter"] = adapter
            # disaggregated placement: a prompt landing on a
            # DEDICATED prefill replica names its decode target NOW —
            # picked from the decode pool by load/free pages — so the
            # prefill replica can stream KV spans there while later
            # chunks still compute. Never on a pinned (chasing) attempt:
            # the stream is already decoding wherever the pin points.
            if pinned is None and self.pool.role(name) == "prefill":
                decode = self._pick_decode(exclude=(name,))
                if decode is not None:
                    payload["decode_target"] = self.pool.url(decode)
                    payload["decode_name"] = decode
            # peer prefix tier: name the ring's next preference
            # owner for this prompt's head key — the replica most likely
            # holding the family's cached KV when the chosen one is cold
            # (an affinity fallback, a scale-out rebalance, a fresh
            # node). Advisory: the replica probes its own tiers first,
            # and a dark or faulted peer degrades to cold prefill. Never
            # on a pinned (chasing) attempt — the stream already exists.
            if pinned is None:
                peer = self._prefix_peer(prompt, exclude=name)
                if peer is not None:
                    peer_url = self.pool.url(peer)
                    if peer_url is not None:
                        payload["prefix_peer"] = peer_url
                        payload["prefix_peer_name"] = peer
            try:
                tup = time.perf_counter()
                body = request_json(
                    url + "/generate", payload, token=self.token,
                    idempotency_key=leg_key,
                    timeout=max(0.1, deadline - time.monotonic()))
                self._metrics.record("upstream",
                                     time.perf_counter() - tup)
            except urllib.error.HTTPError as e:
                detail_obj: dict = {}
                try:
                    detail_obj = json.loads(e.read() or b"{}")
                except Exception:  # noqa: BLE001 — body unreadable
                    pass
                if e.code == 409 and detail_obj.get("migrated"):
                    # the stream moved mid-flight: RE-PIN to the new
                    # owner (epoch-fenced) and retry there — the target
                    # either ADOPTS the restored stream via this same
                    # leg key or serves the request fresh; token-exact
                    # either way
                    self._note_migrated(leg_key, detail_obj["migrated"],
                                        from_replica=name)
                    self._c_repin.inc()
                    self.events.emit(
                        "repin", replica=name,
                        target=detail_obj["migrated"].get("replica"),
                        epoch=detail_obj["migrated"].get("epoch"))
                    continue
                if e.code < 500:
                    # a deterministic CLIENT error (bad sampling params,
                    # oversized prompt) — failing over would just repeat
                    # it and mis-file it as infrastructure trouble;
                    # surface the replica's verdict as-is
                    detail = str(detail_obj.get("error", ""))
                    return e.code, {"error": f"replica {name}: "
                                             f"{detail or f'HTTP {e.code}'}"}
                last_err = f"{name}: HTTP {e.code}"
                # a pinned owner answering 5xx is not serving the pin:
                # drop it so the next attempt re-picks fresh
                self._unpin(leg_key)
                self.pool.refresh(0.0)
                continue
            except TRANSIENT_ERRORS as e:
                last_err = f"{name}: {e}"
                self._unpin(leg_key)
                self.pool.refresh(0.0)
                continue
            self._c_routed.inc()
            self._metrics.record("route", time.perf_counter() - t0)
            self.events.emit("route", replica=name, slo_class=slo_class,
                             affinity=affinity,
                             prompt_tokens=len(prompt),
                             **({"adapter": str(adapter)}
                                if adapter is not None else {}))
            self._unpin(leg_key)     # the stream completed: pin done
            body = dict(body)
            body["replica"] = name
            body["affinity"] = affinity
            return 200, body
        self._c_uperr.inc()
        return 502, {"error": f"upstream generate failed: {last_err}"}

    # -- live migration -------------------------------------------

    def _pinned_replica(self, leg_key: str) -> Optional[str]:
        with self._lock:
            pin = self._pins.get(leg_key)
        if pin is None:
            return None
        name = pin[0]
        if name is None or self.pool.url(name) is None:
            self._unpin(leg_key)
            return None
        return name

    def _unpin(self, leg_key: str) -> None:
        with self._lock:
            self._pins.pop(leg_key, None)

    def _on_replica_restart(self, name: str) -> None:
        """Pool-detected hard restart of *name* (boot nonce changed):
        unpin every mid-stream rid that was bound to it so re-drives
        land on replicas that still hold (or can rebuild) the stream."""
        with self._lock:
            stale = [k for k, pin in self._pins.items() if pin[0] == name]
            for k in stale:
                self._pins.pop(k, None)
        if stale:
            self._c_restart_unpins.inc(len(stale))
            self.events.emit("restart_unpin", replica=name,
                             pins=len(stale))

    def _note_migrated(self, leg_key: str, mig: dict,
                       from_replica: Optional[str] = None) -> None:
        """Record a 409-migrated notice as the request's new owner pin.
        EPOCH-FENCED: a notice at a lower epoch than the recorded pin
        is stale (the stream has since moved again) and must not
        repoint — the at-most-one-active argument's router half. One
        exception: a notice FROM the pinned owner itself always wins —
        the live owner disclaiming the stream is fresher than any
        recorded epoch, and epochs are only comparable within one
        stream lineage (an ambiguous handoff followed by a fresh
        re-admission restarts the lineage at 0, so a strict compare
        would wedge the pin on the old lineage's number)."""
        name = mig.get("replica")
        if not name and mig.get("url"):
            name = self.pool.name_for_url(str(mig["url"]))
        epoch = int(mig.get("epoch", 0))
        with self._lock:
            cur = self._pins.get(leg_key)
            if (cur is not None and epoch < cur[1]
                    and cur[0] != from_replica):
                return
            self._pins[leg_key] = (name, epoch)
            self._pins.move_to_end(leg_key)
            while len(self._pins) > 4096:
                self._pins.popitem(last=False)

    def migrate_away(self, name: str, reason: str = "suspect") -> bool:
        """Ask *name* to hand its in-flight streams to the least-loaded
        OTHER routable replica (a background sweep on the source; this
        call only kicks it). The breaker-suspect policy: a suspect node
        is cordoned but may well still serve — asking it to migrate
        away turns "pray the blackout is transient" into a live
        handoff; if the node is truly dark the POST fails and the
        breaker path continues as before (the honest residue)."""
        src_url = self.pool.url(name)
        # migrate targets must be ROLE-compatible — a suspect
        # prefill replica's streams hand off to another prefill (or
        # "both") replica, never a decode-only one; cross-pool handoffs
        # would load a pool that is sized and SLO-judged for other work
        src_role = self.pool.role(name)
        candidates = [n for n in self.pool.routable()
                      if n != name
                      and role_compatible(src_role, self.pool.role(n))]
        if src_url is None or not candidates:
            self.events.emit("migrate_away_skip", replica=name,
                             reason=reason)
            return False

        def depth(n):
            load = self.pool.snapshot(n) or {}
            return (int(load.get("active_slots", 0)),
                    int(load.get("queue_depth", 0)), n)

        target = min(candidates, key=depth)
        target_url = self.pool.url(target)
        if target_url is None:
            return False
        self._c_migrate_away.inc()
        self.events.emit("migrate_away", replica=name, target=target,
                         reason=reason)
        try:
            request_json(
                src_url + "/migrate_out",
                {"target": target_url, "reason": reason, "wait": False},
                token=self.token, timeout=self.pool.scrape_timeout,
                idempotency_key=f"router-mig-away-{uuid.uuid4().hex}")
        except Exception as e:  # noqa: BLE001 — source dark: the pray path
            self.events.emit("migrate_away_failed", replica=name,
                             error=str(e)[:120])
            return False
        return True

    def _check_suspects(self) -> None:
        """Breaker-suspect -> migrate-away, once per suspect episode:
        the signals loop calls this each tick; a replica newly marked
        SUSPECT gets one migrate-away sweep (repeated ticks must not
        re-spam a struggling node), and recovery to HEALTHY re-arms
        it."""
        for name in self.pool.names():
            st = self.pool.state(name)
            if st == SUSPECT and name not in self._suspect_handled:
                self._suspect_handled.add(name)
                self.migrate_away(name, reason="suspect")
            elif st == HEALTHY:
                self._suspect_handled.discard(name)

    def _sync_ring_roles(self) -> None:
        """Drop ring arcs from replicas whose learned role is DECODE:
        the registration-time decision used whatever role was known
        then, and a correction from the first successful /load scrape
        must not leave a decode-only replica owning prefix buckets
        (every prompt hashed there would be a permanent fallback).
        One-shot per correction — removing a member remaps only its
        own arcs, the register/remove-only membership contract's
        amendment clause."""
        stale = [n for n in self.ring.members()
                 if self.pool.role(n) == "decode"]
        if stale:
            with self._lock:
                for n in stale:
                    self.ring.remove(n)

    # -- adapter distribution (the control-plane surface) ----------

    def adapter_summary(self) -> dict:
        """Registry names + per-replica residency (from the cached
        /load snapshots — no scrape on this path): what ``GET
        /adapters`` serves and ``cli.obs``'s tenants section renders."""
        resident = {}
        for name in self.pool.names():
            load = self.pool.snapshot(name) or {}
            if "resident_adapters" in load:
                resident[name] = list(load.get("resident_adapters") or ())
        return {
            "registered": (self.adapters.names()
                           if self.adapters is not None else []),
            "resident": resident,
        }

    def _adapters_post(self, req: dict):
        """``POST /adapters`` on the router: distribute a REGISTERED
        adapter to replicas ({"name": ..., "replicas"?: [names]} —
        default: every routable multi-LoRA replica), or evict it
        ({"action": "evict", ...}). Per-replica outcomes are reported,
        never collapsed: a partial push is a fact the operator acts on
        (retry the failures), not an error that hides the successes."""
        if self.adapters is None:
            return 404, {"error": "router has no adapter registry"}
        name = req.get("name")
        if not isinstance(name, str) or not name:
            return 400, {"error": "adapter name required"}
        action = str(req.get("action") or "load")
        if action == "load" and name not in self.adapters.names():
            return 404, {"error": f"no registered adapter {name!r}"}
        want = req.get("replicas")
        targets = ([n for n in want if self.pool.url(n) is not None]
                   if isinstance(want, list) else self.pool.routable())
        results = {}
        for rep in targets:
            url = self.pool.url(rep)
            if url is None:
                continue
            try:
                if action == "evict":
                    body = self.adapters.evict_adapter(url, name,
                                                       token=self.token)
                else:
                    body = self.adapters.push_adapter(url, name,
                                                      token=self.token)
                results[rep] = {"ok": True,
                                "resident": body.get("resident")}
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    continue         # not a multi-LoRA replica: skip
                results[rep] = {"ok": False, "code": e.code}
            except Exception as e:  # noqa: BLE001 — per-replica degrade
                results[rep] = {"ok": False, "error": str(e)[:120]}
        self.events.emit("adapter_distribute", name=name, action=action,
                         replicas=len(results))
        return 200, {"name": name, "action": action, "results": results}

    def _admit(self, slo_class: str):
        """The SLO-class gate: (None, None) to proceed; a (code, obj)
        refusal otherwise. Burning = any declared objective's FAST
        window at/over the engine's burn threshold — the early
        multiwindow signal, deliberately more trigger-happy than
        ``firing`` (which also needs the slow window: paging wants
        proof, load-shedding wants reflexes)."""
        if not self._burning():
            return None, None
        if slo_class in self.shed_classes:
            self._c_shed.inc()
            self.events.emit("shed", slo_class=slo_class)
            return 503, {"error": "shed: SLO fast window burning",
                         "slo_class": slo_class}
        if slo_class in self.queue_classes:
            self._c_queued.inc()
            self.events.emit("queue", slo_class=slo_class)
            tq = time.perf_counter()
            q_deadline = time.monotonic() + self.queue_timeout_s
            while time.monotonic() < q_deadline:
                # the signals loop keeps re-evaluating in the background;
                # a parked request only polls the verdict
                time.sleep(0.02)
                if not self._burning():
                    self._metrics.record("queue_wait",
                                         time.perf_counter() - tq)
                    return None, None
            self._c_qtimeout.inc()
            return 503, {"error": "queue timeout: SLO fast window still "
                                  "burning", "slo_class": slo_class}
        return None, None

    # -- SLO evaluation ------------------------------------------------------

    def evaluate_slos(self, min_interval: float = 0.0) -> Dict[str, dict]:
        """Evaluate the declared objectives over the federated fleet
        scrape (throttled by *min_interval*). The router's evaluation
        window is its traffic plus the autoscaler's reconcile cadence —
        both call here."""
        if self.slo is None:
            return {}
        with self._lock:
            now = time.monotonic()
            if min_interval > 0 and now - self._last_slo_eval < min_interval:
                return self.slo.results()
            self._last_slo_eval = now
        return self.slo.evaluate(self.metrics_text())

    def _burning(self) -> bool:
        if self.slo is None:
            return False
        return any(r.get("burn_fast", 0.0) >= self.slo.burn_threshold
                   for r in self.slo.results().values())

    # -- observability -------------------------------------------------------

    def metrics_text(self) -> str:
        """Router registry federated with every replica's ``/metrics``
        (series relabeled ``replica="<name>"``) — what ``GET /metrics``
        serves and what the SLO engine judges."""
        return self.pool.federate_text(self.registry.render())

    def trace(self, trace_id: str) -> dict:
        """One stitched trace: router spans + every replica's leg."""
        spans = {s["span_id"]: s
                 for s in obs_trace.tracer().spans(trace_id)}
        self.pool.trace(trace_id, spans)
        ordered = sorted(spans.values(), key=lambda s: s["start"])
        return {"trace": trace_id, "spans": ordered}

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _poll_loop(self) -> None:
        """The background signals loop: fleet /load refresh + SLO
        evaluation over the federated scrape, OFF the request path — a
        dark replica's scrape timeout must inflate a background tick,
        never a routed request's latency (the controller's concurrent-
        scrape lesson: observability overhead that trips the very
        latency objective it feeds is self-inflicted load shedding).
        Handlers only read the cached snapshots and the engine's last
        verdicts."""
        interval = max(0.05, min(self.load_refresh_s or 0.25,
                                 self._slo_interval or 0.25))
        while not self._stop.wait(interval):
            try:
                # both halves keep their OWN configured cadence — the
                # tick rate is just the scheduler granularity
                self.pool.refresh(self.load_refresh_s)
                # SLO evaluation keeps its OWN cadence: the federation
                # scrape + parse is the dear half, so a fast load tick
                # must not drag it along (the throttle returns cached
                # verdicts inside slo_interval_s)
                self.evaluate_slos(self._slo_interval)
                # breaker-suspect -> migrate-away: the sweep
                # itself runs on the SOURCE replica in the background —
                # this tick only asks, so a slow transfer never stalls
                # the signals loop
                self._check_suspects()
                # revoke ring arcs granted on a STALE role
                # (an explicit-name registration whose seed scrape
                # missed defaults to "both"; the replica's own /load
                # word corrects the handle later, but ring membership
                # only changes here) — a decode replica must never
                # keep owning prefix buckets
                self._sync_ring_roles()
            except Exception:  # noqa: BLE001 — the loop survives a bad
                pass           # scrape; next tick retries

    def start(self) -> str:
        self._stop.clear()
        self._loop_thread = threading.Thread(
            target=self._poll_loop, name="kubetpu-router-signals",
            daemon=True)
        self._loop_thread.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="kubetpu-router",
            daemon=True)
        self._thread.start()
        return self.address

    def shutdown(self, timeout: float = 5.0) -> None:
        self._inflight.wait_idle(timeout)
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
            self._loop_thread = None
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

