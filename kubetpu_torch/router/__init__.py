"""The port of ``kubetpu.router`` that a serving replica needs:

- :mod:`kubetpu_torch.router.replica` — ``ReplicaServer``, a slot server's
  wire surface: idempotent ``POST /generate``, graceful drain, live
  migration (``/migrate_out``, the chunked ``/migrate_in`` with its epoch
  fence), the peer prefix fetch and the disaggregated prefill -> decode
  handoff;
- :mod:`kubetpu_torch.router.migration` — the snapshot wire codec, byte
  for byte the JAX package's, with bfloat16 pages carried as their 16-bit
  patterns;
- :mod:`kubetpu_torch.router.adapters` — the multi-LoRA control plane:
  the adapter codec (the JAX package's bytes, bf16 included) and the
  content-hashed ``AdapterRegistry`` that pushes adapters to a replica's
  ``POST /adapters``.

``RouterServer``, the replica pool, the hash ring and the autoscaler are
not ported yet (ROADMAP queue 1, the router side): a port replica speaks
the JAX package's protocol, so ``kubetpu.router.RouterServer`` can front
it from a process of its own.
"""

from kubetpu_torch.router.migration import decode_snapshot, encode_snapshot
from kubetpu_torch.router.replica import ReplicaServer

__all__ = ["ReplicaServer", "decode_snapshot", "encode_snapshot"]
