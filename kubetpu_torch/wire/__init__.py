"""The port of ``kubetpu.wire`` that a serving replica needs:

- ``httpcommon`` — the shared retrying client (``request_json`` +
  ``RetryPolicy``: jittered exponential backoff, per-call deadlines,
  POST-only-with-key retry safety), the server-side idempotency replay
  window and the per-request guard (trace context, fault hook);
- ``faults`` — deterministic (seeded) per-route fault injection for chaos
  testing, installable into the servers and the urllib client path.

Both are copies of the JAX package's modules (stdlib only), so a port
replica and a ``kubetpu`` router or replica speak one protocol. The node
agent, the controller and the KubeDevice codec of ``kubetpu.wire`` are not
ported: they drive the scheduler, not the model.
"""

from kubetpu_torch.wire.faults import FaultInjector, RoutePolicy
from kubetpu_torch.wire.httpcommon import (
    NO_RETRY,
    IdempotencyCache,
    RetryPolicy,
    request_json,
)

__all__ = [
    "FaultInjector",
    "IdempotencyCache",
    "NO_RETRY",
    "RetryPolicy",
    "RoutePolicy",
    "request_json",
]
