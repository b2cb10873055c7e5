"""Deterministic fault injection for the wire stack (a copy of
``kubetpu/wire/faults.py``).

The reference inherits Kubernetes' fault tolerance; kubetpu owns its own
control plane, so it must *earn* it — and earned tolerance needs a way to
manufacture the faults it claims to survive. This module is that layer: a
seeded, per-route fault policy installable into both halves of the wire —

- the stdlib HTTP servers (``NodeAgentServer`` / ``ControllerServer`` take
  ``faults=``): each request consults the injector BEFORE routing and may
  be dropped (connection reset, nothing executed), delayed, answered with
  an injected 503 (nothing executed), or answered with a PARTIAL response
  (the handler runs to completion — side effects committed — but the body
  is truncated mid-write, so the client sees an ``IncompleteRead``). The
  partial fault is the important one: it manufactures the
  "processed-but-response-lost" window that makes naive POST retries
  double-allocate, which the idempotency-key dedup must absorb;
- the urllib client path (``RemoteDevice(faults=)`` /
  ``request_json(faults=)``, or process-wide via ``install_client``):
  outbound calls may be dropped (``ConnectionResetError`` before any bytes
  reach the server) or delayed.

Every draw comes from one ``random.Random(seed)`` under a lock, so a chaos
run replays bit-for-bit given the same seed and request order; per-policy
``times`` bounds turn a policy into a deterministic script ("fail the next
call, then behave") for targeted tests.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

# fault kinds (the injector's verdict for one request)
OK = "ok"
DROP = "drop"          # reset the connection; the request never executes
DELAY = "delay"        # added latency, then normal handling
ERROR = "error"        # injected 5xx; the request never executes
PARTIAL = "partial"    # request EXECUTES; response body truncated


@dataclass
class RoutePolicy:
    """Per-route fault probabilities. All default to 0 (no injection).

    ``times``: when set, the policy disarms after injecting that many
    faults — a deterministic "fail exactly N calls" script. ``None`` =
    unlimited."""

    drop: float = 0.0
    delay: float = 0.0
    delay_s: float = 0.05
    error: float = 0.0
    error_code: int = 503
    partial: float = 0.0
    times: Optional[int] = None
    injected: int = field(default=0, compare=False)

    def rate(self) -> float:
        return self.drop + self.delay + self.error + self.partial


class FaultInjector:
    """Seeded per-route fault decisions, shared by servers and clients.

    Routes are matched by the LONGEST registered path prefix; the
    ``default`` policy covers everything unmatched. One injector may be
    installed into several servers at once (the chaos soak drives a whole
    controller + N agents off one seed)."""

    def __init__(
        self,
        seed: int = 0,
        default: Optional[RoutePolicy] = None,
        routes: Optional[Dict[str, RoutePolicy]] = None,
    ) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.default = default or RoutePolicy()
        self.routes: Dict[str, RoutePolicy] = dict(routes or {})
        self.counts: Dict[str, int] = {}

    # -- policy management ---------------------------------------------------

    def set_route(self, prefix: str, policy: RoutePolicy) -> None:
        with self._lock:
            self.routes[prefix] = policy

    def set_default(self, policy: RoutePolicy) -> None:
        with self._lock:
            self.default = policy

    def clear(self) -> None:
        """Stop injecting (keep counters) — 'the network heals'."""
        with self._lock:
            self.default = RoutePolicy()
            self.routes = {}

    def policy_for(self, path: str) -> RoutePolicy:
        best, best_len = self.default, -1
        for prefix, pol in self.routes.items():
            if path.startswith(prefix) and len(prefix) > best_len:
                best, best_len = pol, len(prefix)
        return best

    # -- decisions -----------------------------------------------------------

    def decide(self, path: str, kinds=None) -> RoutePolicy | tuple:
        """(kind, policy) for one request at *path* — ONE rng draw under
        the lock so concurrent requests replay deterministically given a
        fixed arrival order. *kinds*: the fault kinds the CALLER can
        enact (the client path can only drop/delay); a verdict outside it
        resolves to OK WITHOUT consuming a ``times`` charge or a counter,
        so a scripted server-side fault can't be burned by a client
        call."""
        with self._lock:
            pol = self.policy_for(path)
            if pol.times is not None and pol.injected >= pol.times:
                return OK, pol
            r = self._rng.random()
            for kind, p in ((DROP, pol.drop), (DELAY, pol.delay),
                            (ERROR, pol.error), (PARTIAL, pol.partial)):
                if r < p:
                    if kinds is not None and kind not in kinds:
                        return OK, pol
                    pol.injected += 1
                    self.counts[kind] = self.counts.get(kind, 0) + 1
                    return kind, pol
                r -= p
            return OK, pol

    # -- server installation -------------------------------------------------

    def server_fault(self, handler) -> bool:
        """Consult the injector for one server request. Returns True when
        the request was fully consumed (drop/error) and the handler must
        return WITHOUT executing; False to proceed (possibly after an
        injected delay, possibly with ``handler._fault_truncate`` set so
        the reply writer truncates the body — see httpcommon.write_json)."""
        from kubetpu_torch.wire.httpcommon import write_json

        kind, pol = self.decide(handler.path)
        if kind == DROP:
            # reset without a status line: the client sees the connection
            # die (RemoteDisconnected / ConnectionReset), not an HTTP error
            handler.close_connection = True
            try:
                handler.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return True
        if kind == DELAY:
            time.sleep(pol.delay_s)
            return False
        if kind == ERROR:
            write_json(handler, pol.error_code,
                       {"error": f"injected fault: {pol.error_code}"})
            return True
        if kind == PARTIAL:
            handler._fault_truncate = True
            return False
        return False

    # -- client installation -------------------------------------------------

    def client_fault(self, path: str) -> None:
        """Consult the injector for one OUTBOUND client call: an injected
        drop raises ``ConnectionResetError`` before any bytes leave (the
        retry layer sees a transient connection failure); a delay sleeps.
        Error/partial are server-side kinds — their charges are left for
        the server to consume (``decide(kinds=...)``)."""
        kind, pol = self.decide(path, kinds=(DROP, DELAY))
        if kind == DROP:
            raise ConnectionResetError(f"injected client drop on {path}")
        if kind == DELAY:
            time.sleep(pol.delay_s)


# -- process-wide client hook (the urllib path) ------------------------------

_client_injector: Optional[FaultInjector] = None


def install_client(injector: Optional[FaultInjector]) -> None:
    """Install *injector* into the shared urllib client path: every
    ``request_json`` call without an explicit ``faults=`` consults it.
    Pass None to uninstall."""
    global _client_injector
    _client_injector = injector


def client_injector() -> Optional[FaultInjector]:
    return _client_injector
