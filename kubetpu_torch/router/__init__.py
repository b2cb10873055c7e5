"""The port of ``kubetpu.router``, the prefix-affinity data plane in front
of N serving replicas:

- :mod:`kubetpu_torch.router.server` — ``RouterServer``: consistent-hash
  on the tokenized prefix head (:mod:`kubetpu_torch.router.hashring`),
  load fallback from each replica's ``/load`` snapshot, SLO-class
  admission over the federated ``/metrics``, the 409 re-pin of a migrated
  stream, the decode pick of a disaggregated fleet, the tenant-affine pick
  over resident adapters and the ``/adapters`` distribution;
- :mod:`kubetpu_torch.router.pool` — ``ReplicaPool``: registration,
  breaker health (healthy -> suspect -> dead, with probation), boot-nonce
  fencing, drain tracking, federation and trace stitching;
- :mod:`kubetpu_torch.router.autoscaler` — ``ReplicaAutoscaler``: per-role
  pools scaled from the federated signals with hysteresis, crash
  replacement, and migrate-then-remove scale-down;
- :mod:`kubetpu_torch.router.replica` — ``ReplicaServer``, a slot
  server's wire surface (idempotent ``POST /generate``, drain, live
  migration, the peer prefix fetch, the disaggregated handoff,
  ``/adapters``);
- :mod:`kubetpu_torch.router.migration` — the snapshot wire codec, byte
  for byte the JAX package's (bfloat16 pages as their 16-bit patterns);
- :mod:`kubetpu_torch.router.adapters` — the adapter codec and the
  content-hashed ``AdapterRegistry`` the router distributes from.

The protocol is the JAX package's, so either package's router fronts
either package's replicas. The router, pool, ring and autoscaler hold no
model and import no torch; importing this package imports torch only
through the replica's codec.
"""

from kubetpu_torch.router.autoscaler import ReplicaAutoscaler, ScalePolicy
from kubetpu_torch.router.hashring import HashRing, prefix_head_key
from kubetpu_torch.router.migration import decode_snapshot, encode_snapshot
from kubetpu_torch.router.pool import ReplicaPool, role_compatible
from kubetpu_torch.router.replica import ReplicaServer
from kubetpu_torch.router.server import RouterServer

__all__ = [
    "HashRing",
    "ReplicaAutoscaler",
    "ReplicaPool",
    "ReplicaServer",
    "RouterServer",
    "ScalePolicy",
    "decode_snapshot",
    "encode_snapshot",
    "prefix_head_key",
    "role_compatible",
]
