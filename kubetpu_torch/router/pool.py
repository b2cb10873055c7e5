"""``ReplicaPool`` — the router's replica registry, health breaker and
load snapshot cache (port of ``kubetpu/router/pool.py``).

The control plane already knows how to keep a fleet honest
(circuit-breaker node health, graceful drain); this module applies the
same discipline to serving replicas behind the data plane:

- **registration**: ``add(url)`` probes ``/healthz`` to learn the
  replica's name (idempotent at the same URL — re-registering is a
  no-op), ``remove(name)`` forgets it;
- **breaker health**: every ``refresh()`` probes ``/load``; the states
  and transitions mirror the controller's breaker
  (healthy -> suspect -> probation -> dead): ``suspect_after``
  consecutive misses cordons the replica out of routing WITHOUT
  forgetting it (a transient blackout costs zero remaps — ring
  membership only changes on register/remove), ``dead_after`` misses
  marks it dead, a success moves suspect to probation and
  ``probation_passes`` consecutive successes restore healthy. Every
  transition lands in the event log;
- **load snapshots**: the ``/load`` body (queue depth, active slots,
  pool free pages, prefix hit rate — ``SlotServerBase.load_info``) is
  cached per replica; ``refresh(min_interval)`` is throttled so the
  per-request routing path reads a fresh-enough snapshot without
  scraping per request. Scrapes run CONCURRENTLY (the controller's
  federation shape): N dark replicas cost one timeout, not N;
- **drain tracking**: ``drain(name)`` POSTs the replica's ``/drain``
  (idempotency-keyed) and marks the handle; ``drained(name)`` reads
  the last snapshot — draining AND idle — which is the autoscaler's
  scale-down-only-after-drain gate;
- **federation**: ``federate_text(own)`` merges every replica's
  ``/metrics`` into one exposition (series relabeled
  ``replica="<name>"``) and ``trace(id)`` stitches replica trace legs
  — the router's ``/metrics`` and ``/trace/<id>`` surfaces.

All scrapes ride the shared retrying client (``request_text`` /
``request_json`` — KTP002), ``NO_RETRY`` for probes (a missed probe is
breaker evidence, not an outage worth backoff).
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from kubetpu_torch.obs.events import EventLog
from kubetpu_torch.obs.registry import Registry, federate
from kubetpu_torch.wire.httpcommon import NO_RETRY, request_json, request_text

# breaker states — the controller's strings (wire.controller), repeated
# here so the router package never imports the control plane
HEALTHY = "healthy"
SUSPECT = "suspect"
PROBATION = "probation"
DEAD = "dead"

# serving roles (disaggregated prefill/decode)
ROLES = ("prefill", "decode", "both")


def role_compatible(src_role: Optional[str],
                    dst_role: Optional[str]) -> bool:
    """May *dst* take over *src*'s in-flight streams? Same pool or a
    colocated ``"both"`` node — never across dedicated pools: a suspect
    PREFILL replica's streams hand off to another prefill (or both)
    replica, not a decode-only one whose pool is sized and SLO-judged
    for pure decode traffic (and vice versa). Unknown roles read as
    ``"both"`` (a fleet without roles)."""
    src = src_role or "both"
    dst = dst_role or "both"
    return dst == "both" or dst == src


class ReplicaHandle:
    """One replica's registration + breaker + last load snapshot."""

    def __init__(self, name: str, url: str, role: str = "both") -> None:
        self.name = name
        self.url = url.rstrip("/")
        self.role = role if role in ROLES else "both"
        self.state = HEALTHY
        self.misses = 0
        self.passes = 0
        self.draining = False
        self.load: Optional[dict] = None
        self.last_seen = 0.0
        # boot-nonce fencing: the replica process's per-boot
        # identity (from /healthz and /load). A changed nonce under the
        # same name means the process restarted — its KV cache is gone
        # and any mid-stream state with it.
        self.nonce: Optional[str] = None

    def routable(self) -> bool:
        return self.state in (HEALTHY, PROBATION) and not self.draining

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "url": self.url,
            "role": self.role,
            "state": self.state,
            "draining": self.draining,
            "load": self.load,
        }


class ReplicaPool:
    """Thread-safe replica registry + breaker + snapshot cache."""

    def __init__(
        self,
        token: Optional[str] = None,
        suspect_after: int = 2,
        dead_after: int = 5,
        probation_passes: int = 2,
        scrape_timeout: float = 2.0,
        registry: Optional[Registry] = None,
        events: Optional[EventLog] = None,
    ) -> None:
        if not 1 <= suspect_after <= dead_after:
            raise ValueError("need 1 <= suspect_after <= dead_after")
        self.token = token
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.probation_passes = probation_passes
        self.scrape_timeout = scrape_timeout
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else EventLog(
            component="router")
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._last_refresh = 0.0
        # observers of hard-kill restarts (same name, new
        # boot nonce) — the router drops its mid-stream pins here
        self._restart_cbs: List = []
        self._c_restarts = self.registry.counter(
            "kubetpu_router_replica_restarts_total",
            "replicas seen returning with a NEW boot nonce (cache-wiped)")
        self._c_takeovers = self.registry.counter(
            "kubetpu_router_replica_takeovers_total",
            "same-name re-registrations that took over a dead/restarted "
            "handle")
        for state in (HEALTHY, SUSPECT, PROBATION, DEAD):
            # state ranges over the fixed literal tuple above (KTP004's
            # bounded proof); closure binds the loop variable by default
            self.registry.gauge_fn(
                "kubetpu_router_replicas",
                lambda s=state: self._count_state(s), state=state)

    def _count_state(self, state: str) -> int:
        with self._lock:
            return sum(1 for h in self._replicas.values()
                       if h.state == state)

    # -- restart observation --------------------------------------

    def on_restart(self, cb) -> None:
        """Register ``cb(name)`` to fire when a replica is recognized as
        restarted (same name, new boot nonce) — takeover registrations
        included. Callbacks run outside the pool lock; exceptions are
        swallowed (an observer must not break breaker bookkeeping)."""
        self._restart_cbs.append(cb)

    def _fire_restart(self, name: str) -> None:
        self._c_restarts.inc()
        for cb in list(self._restart_cbs):
            try:
                cb(name)
            except Exception:  # noqa: BLE001 — observers are best-effort
                pass

    # -- membership ----------------------------------------------------------

    def add(self, url: str, name: Optional[str] = None,
            role: Optional[str] = None) -> str:
        """Register a replica by URL; probes ``/healthz`` for its name
        (serving ROLE and boot nonce) unless
        given. Idempotent: the same URL re-registers as the same handle
        (breaker state kept). A DIFFERENT url under an existing name is
        refused — silently swapping the handle would orphan the first
        replica (running, unobserved, undrained) and repoint its ring
        arcs — UNLESS the newcomer is a legitimate restart of the same
        replica: the existing handle is breaker-DEAD, or the probe
        returned a boot nonce the handle doesn't carry. A restart TAKES
        OVER the handle in place (``replica_takeover`` event): the name
        keeps its ring arcs, the breaker walks probation from suspect,
        and restart observers fire so the router drops its mid-stream
        pins."""
        url = url.rstrip("/")
        probed_nonce = None
        if name is None:
            body = request_json(url + "/healthz",
                                timeout=self.scrape_timeout)
            name = body.get("replica") or url
            role = role or body.get("role")
            probed_nonce = body.get("boot_nonce")
        # explicit-name registration stays probe-free: the role
        # defaults to "both" and the replica's own /load word corrects
        # it on the first refresh (the router refreshes right after
        # registering, before granting ring arcs)
        role = role or "both"
        takeover_from = None
        with self._lock:
            existing = self._replicas.get(name)
            if existing is not None:
                if existing.url == url:
                    return name
                restarted = (
                    existing.state == DEAD
                    or (probed_nonce is not None
                        and existing.nonce is not None
                        and probed_nonce != existing.nonce))
                if not restarted:
                    raise ValueError(
                        f"replica name {name!r} is already registered at "
                        f"{existing.url}; remove it before registering "
                        f"{url}")
                takeover_from = existing.url
                existing.url = url
                existing.role = role if role in ROLES else existing.role
                existing.nonce = probed_nonce
                # the restarted process is cache-wiped and unproven: it
                # re-earns routing through probation (the next clean
                # /load probe moves SUSPECT -> PROBATION), and its old
                # load snapshot is meaningless
                existing.state = SUSPECT
                existing.misses = 0
                existing.passes = 0
                existing.load = None
            else:
                h = ReplicaHandle(name, url, role=role)
                h.nonce = probed_nonce
                self._replicas[name] = h
        if takeover_from is not None:
            self._c_takeovers.inc()
            self.events.emit("replica_takeover", replica=name, url=url,
                             old_url=takeover_from)
            self._fire_restart(name)
            return name
        self.events.emit("replica_register", replica=name, url=url,
                         role=role)
        return name

    def remove(self, name: str) -> bool:
        with self._lock:
            gone = self._replicas.pop(name, None)
        if gone is not None:
            self.events.emit("replica_remove", replica=name)
        return gone is not None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def routable(self) -> List[str]:
        with self._lock:
            return sorted(n for n, h in self._replicas.items()
                          if h.routable())

    def url(self, name: str) -> Optional[str]:
        with self._lock:
            h = self._replicas.get(name)
            return h.url if h is not None else None

    def role(self, name: str) -> Optional[str]:
        """The replica's serving role (``prefill``/``decode``/``both``;
        None for unknown names). Placement, migrate-target selection
        and the per-pool autoscaler all key on this."""
        with self._lock:
            h = self._replicas.get(name)
            return h.role if h is not None else None

    def snapshot(self, name: str) -> Optional[dict]:
        """The last ``/load`` body for *name* (None before the first
        successful refresh)."""
        with self._lock:
            h = self._replicas.get(name)
            return dict(h.load) if h is not None and h.load else None

    def to_json(self) -> List[dict]:
        with self._lock:
            return [h.to_json() for _n, h in sorted(self._replicas.items())]

    # -- health + load refresh -----------------------------------------------

    def refresh(self, min_interval: float = 0.0) -> bool:
        """Scrape every replica's ``/load`` (concurrently), update
        snapshots and breaker states. Throttled: returns False without
        scraping when the last refresh is younger than *min_interval*
        (the per-request routing path passes its staleness budget; the
        autoscaler passes 0 for a fresh view)."""
        with self._lock:
            now = time.monotonic()
            if min_interval > 0 and now - self._last_refresh < min_interval:
                return False
            self._last_refresh = now
            targets = [(h.name, h.url) for h in self._replicas.values()]
        if not targets:
            return True

        def scrape(item):
            name, url = item
            try:
                return name, request_json(
                    url + "/load", token=self.token,
                    timeout=self.scrape_timeout, retry=NO_RETRY)
            except Exception:  # noqa: BLE001 — a miss is breaker evidence
                return name, None

        with ThreadPoolExecutor(max_workers=min(16, len(targets))) as pool:
            results = list(pool.map(scrape, sorted(targets)))
        for name, load in results:
            if load is None:
                self._record_miss(name)
            else:
                self._record_ok(name, load)
        return True

    def _record_miss(self, name: str) -> None:
        with self._lock:
            h = self._replicas.get(name)
            if h is None or h.state == DEAD:
                return
            h.misses += 1
            h.passes = 0
            misses, transition = h.misses, None
            if h.misses >= self.dead_after:
                h.state, transition = DEAD, "replica_dead"
            elif h.state != SUSPECT and h.misses >= self.suspect_after:
                h.state, transition = SUSPECT, "replica_suspect"
        if transition:
            self.events.emit(transition, replica=name, misses=misses)

    def _record_ok(self, name: str, load: dict) -> None:
        restarted = False
        with self._lock:
            h = self._replicas.get(name)
            if h is None:
                return
            # boot-nonce fencing: a /load answering under the
            # same name with a NEW nonce is a hard-killed-and-restarted
            # process — its KV cache and in-flight streams are gone.
            # Force the breaker to SUSPECT so the normal ok-path below
            # walks it through probation (never straight back to
            # healthy on the very probe that revealed the restart), and
            # let the restart observers (the router's unpin hook) fire.
            nonce = load.get("boot_nonce")
            if (nonce is not None and h.nonce is not None
                    and nonce != h.nonce):
                restarted = True
                h.state = SUSPECT
                h.passes = 0
            if nonce is not None:
                h.nonce = nonce
            h.load = dict(load)
            if load.get("role") in ROLES:
                h.role = load["role"]     # the replica's own word wins
            # the LOCAL cordon is sticky: pool.drain() promises the
            # router stops routing even when the /drain POST was lost,
            # so a replica still reporting draining=False must not
            # un-cordon the handle (replicas have no un-drain path —
            # only remove/re-add resets it)
            h.draining = h.draining or bool(load.get("draining"))
            h.last_seen = time.time()
            h.misses = 0
            transition = None
            if h.state in (DEAD, SUSPECT):
                # a dead/suspect replica answering again re-earns
                # routing the slow way, like the controller's breaker:
                # through probation, never straight to healthy
                h.state, h.passes = PROBATION, 1
                transition = "replica_probation"
            elif h.state == PROBATION:
                h.passes += 1
                if h.passes >= self.probation_passes:
                    h.state, transition = HEALTHY, "replica_recovered"
        if restarted:
            self.events.emit("replica_restart", replica=name)
            self._fire_restart(name)
        if transition:
            self.events.emit(transition, replica=name)

    # -- drain ---------------------------------------------------------------

    def drain(self, name: str, migrate_to: Optional[str] = None,
              reason: str = "drain") -> bool:
        """Ask *name* to drain (idempotency-keyed POST) and stop routing
        to it. With *migrate_to* (a replica URL) the drain is a LIVE
        HANDOFF: the replica migrates its in-flight streams there
        token-exactly and completes immediately instead of
        waiting out every stream. Returns False for unknown replicas; a
        failed POST still cordons the handle (the router stops sending
        work either way — the replica-side refusal is belt on top of
        braces)."""
        with self._lock:
            h = self._replicas.get(name)
            if h is None:
                return False
            h.draining = True
            url = h.url
        body: dict = {"reason": reason}
        if migrate_to:
            body["migrate_to"] = migrate_to
        try:
            request_json(url + "/drain", body, token=self.token,
                         timeout=self.scrape_timeout,
                         idempotency_key=f"router-drain-{uuid.uuid4().hex}")
        except Exception:  # noqa: BLE001 — cordon held locally regardless
            pass
        return True

    def name_for_url(self, url: str) -> Optional[str]:
        """Registered name owning *url* (None when unknown) — how the
        router resolves a migrated-to target named only by URL."""
        url = url.rstrip("/")
        with self._lock:
            for n, h in self._replicas.items():
                if h.url == url:
                    return n
        return None

    def drained(self, name: str) -> bool:
        """True once the replica's LAST snapshot shows it draining and
        idle — no active slots, nothing queued, no in-flight prefills.
        The autoscaler's remove gate: scale-down completes only here.
        A DEAD victim counts as drained: its streams are already gone,
        and waiting on a snapshot a dead replica can never refresh
        would wedge the scale-down forever."""
        with self._lock:
            h = self._replicas.get(name)
            if h is None:
                return True          # already gone
            if h.state == DEAD:
                return True
            load = h.load
            if not h.draining or load is None:
                return False
        return (int(load.get("active_slots", 1)) == 0
                and int(load.get("queue_depth", 1)) == 0
                and int(load.get("inflight_prefills", 0)) == 0
                # a slot frozen mid-handoff is NOT drained: removing
                # the source before its commit-ack drops the stream
                and int(load.get("migrating_slots", 0)) == 0
                and bool(load.get("draining")))

    def alive(self) -> List[str]:
        """Names whose breaker state is not DEAD — what capacity
        decisions (the autoscaler's max_replicas gate) count; a dead
        handle is evidence, not capacity."""
        with self._lock:
            return sorted(n for n, h in self._replicas.items()
                          if h.state != DEAD)

    def state(self, name: str) -> Optional[str]:
        with self._lock:
            h = self._replicas.get(name)
            return h.state if h is not None else None

    def tier_summary(self) -> dict:
        """Fleet view of the tiered KV cache, aggregated
        from the cached ``/load`` snapshots: total host-tier bytes and
        nodes, per-tier hit/fill/spill counts summed across replicas,
        and how many replicas have the tier enabled. The cli's tiering
        line and the operator's budget-sizing loop read this instead of
        scraping N ``/metrics`` expositions."""
        out = {
            "replicas": 0,
            "tiered_replicas": 0,
            "host_bytes": 0,
            "host_nodes": 0,
            "hits": {"hbm": 0, "host": 0, "peer": 0},
            "fills": {"host": 0, "peer": 0},
            "spills": {"host": 0},
        }
        with self._lock:
            loads = [dict(h.load) for h in self._replicas.values()
                     if h.load]
        out["replicas"] = len(loads)
        for load in loads:
            if "tier_host_bytes" not in load:
                continue
            out["tiered_replicas"] += 1
            out["host_bytes"] += int(load.get("tier_host_bytes", 0))
            out["host_nodes"] += int(load.get("tier_host_nodes", 0))
            for key in ("hits", "fills", "spills"):
                for tier, n in (load.get(f"tier_{key}") or {}).items():
                    if tier in out[key]:
                        out[key][tier] += int(n)
        return out

    # -- federation ----------------------------------------------------------

    def federate_text(self, own: str) -> str:
        """*own* exposition merged with every replica's ``/metrics``,
        replica series relabeled ``replica="<name>"``. Failures skip
        that replica and count — federation degrades, never 500s."""
        with self._lock:
            targets = [(h.name, h.url) for h in self._replicas.values()]
        scraped: Dict[str, str] = {}

        def scrape(item):
            name, url = item
            try:
                return name, request_text(
                    url + "/metrics", token=self.token,
                    timeout=self.scrape_timeout, retry=NO_RETRY)
            except Exception:  # noqa: BLE001 — degrade per replica
                self.registry.counter(
                    "kubetpu_router_federation_scrape_errors_total").inc()
                return name, None

        if targets:
            with ThreadPoolExecutor(
                    max_workers=min(16, len(targets))) as pool:
                for name, text in pool.map(scrape, sorted(targets)):
                    if text is not None:
                        scraped[name] = text
        return federate(own, scraped, label="replica")

    def trace(self, trace_id: str, spans: Dict[str, dict]) -> None:
        """Merge every replica's ``/trace/<id>`` leg into *spans*
        (span_id-keyed, first writer wins — in-process fleets share the
        tracer, cross-process ones don't)."""
        with self._lock:
            targets = [(h.name, h.url) for h in self._replicas.values()]
        for _name, url in sorted(targets):
            try:
                body = request_json(
                    f"{url}/trace/{trace_id}", token=self.token,
                    timeout=self.scrape_timeout, retry=NO_RETRY)
                for s in body.get("spans", []):
                    spans.setdefault(s["span_id"], s)
            except Exception:  # noqa: BLE001 — a dark replica loses its
                pass           # leg, not the whole trace
