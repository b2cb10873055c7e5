"""Adapter registry and distribution: the multi-LoRA control plane (port of
``kubetpu/router/adapters.py``).

The data-plane half lives in ``kubetpu_torch.jobs.multi_lora`` (one packed
replica, a stacked adapter tree, per-slot integer retargeting). This
module is the fleet half: where adapter weights live before a replica
holds them, and how they move.

- ``AdapterRegistry``: the controller-side source of truth, content-hashed
  (``adapter_fingerprint``), so an adapter's name is its bytes and two
  registries, in either package, agree on every name;
- ``encode_adapter`` / ``decode_adapter``: the wire codec (per-leaf dtype,
  shape and base64 bytes), byte for byte the JAX package's. bf16 leaves
  travel as their 16-bit patterns under ``"bfloat16"`` and decode as
  ``torch.bfloat16`` CPU tensors (the snapshot codec's handling,
  ``router.migration``); other dtypes decode as numpy;
- ``push_adapter`` / ``evict_adapter``: the replica legs over
  ``POST /adapters``, idempotency-keyed per attempt (a retried push whose
  first response was lost replays; the replica's load is
  content-idempotent besides).
"""

from __future__ import annotations

import base64
import threading
import uuid
from typing import Dict, List, Optional

import torch

from kubetpu_torch.jobs.multi_lora import adapter_fingerprint
from kubetpu_torch.router.migration import decode_array, encode_array
from kubetpu_torch.wire.httpcommon import request_json

DEFAULT_PUSH_TIMEOUT = 10.0


def encode_adapter(adapter) -> dict:
    """One adapter tree (``lora.init_lora_params`` layout; leaves tensors
    or numpy arrays) -> a JSON-safe wire object: {"blocks": {leaf: {dtype,
    shape, data (b64)}}}, leaves in the tree's order."""
    out = {}
    for k, v in adapter["blocks"].items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        spec, raw = encode_array(k, v)
        out[k] = {"dtype": spec["dtype"], "shape": spec["shape"],
                  "data": base64.b64encode(raw).decode("ascii")}
    return {"blocks": out}


def decode_adapter(obj: dict) -> dict:
    """Inverse of ``encode_adapter``; ``ValueError`` on any malformed leaf
    (the wire handler's 400)."""
    blocks = obj.get("blocks")
    if not isinstance(blocks, dict) or not blocks:
        raise ValueError("adapter payload needs a non-empty blocks map")
    out = {}
    for k, leaf in blocks.items():
        try:
            raw = base64.b64decode(leaf["data"])
            spec = {"dtype": leaf["dtype"],
                    "shape": [int(d) for d in leaf["shape"]]}
            out[k] = decode_array(spec, raw)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"adapter leaf {k!r} malformed: {e}") from e
    return {"blocks": out}


class AdapterRegistry:
    """Content-hashed adapter store: the fleet's source of truth.

    ``register`` names an adapter by its fingerprint (or an explicit
    alias); the same bytes re-register as a no-op, the same alias over
    different bytes refuses (an alias must never silently retarget:
    tenants route by it). Encoded wire payloads are cached per name, so
    pushing one adapter to N replicas encodes once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._adapters: Dict[str, dict] = {}     # name -> tree
        self._encoded: Dict[str, dict] = {}      # name -> wire payload
        self._digest: Dict[str, str] = {}        # name -> fingerprint

    def register(self, adapter, name: Optional[str] = None) -> str:
        fp = adapter_fingerprint(adapter)
        name = name or fp
        with self._lock:
            have = self._digest.get(name)
            if have is not None:
                if have != fp:
                    raise ValueError(
                        f"adapter name {name!r} is already registered "
                        f"with different content")
                return name
            self._adapters[name] = adapter
            self._digest[name] = fp
        return name

    def get(self, name: str):
        with self._lock:
            a = self._adapters.get(name)
        if a is None:
            raise KeyError(f"no registered adapter {name!r}")
        return a

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._adapters)

    def __len__(self) -> int:
        with self._lock:
            return len(self._adapters)

    def encoded(self, name: str) -> dict:
        with self._lock:
            enc = self._encoded.get(name)
            if enc is None:
                a = self._adapters.get(name)
                if a is None:
                    raise KeyError(f"no registered adapter {name!r}")
                enc = encode_adapter(a)
                self._encoded[name] = enc
        return enc

    # -- replica legs --------------------------------------------------------

    def push_adapter(self, replica_url: str, name: str,
                     token: Optional[str] = None,
                     timeout: float = DEFAULT_PUSH_TIMEOUT) -> dict:
        """Hot-load the registered adapter *name* into one replica over
        ``POST /adapters``. The idempotency key is per attempt: retries
        inside ``request_json`` reuse it (a lost response replays the
        committed answer), while a later push after an evict re-executes
        under a fresh key. Raises on a definitive wire refusal."""
        return request_json(
            replica_url.rstrip("/") + "/adapters",
            {"action": "load", "name": name,
             "adapter": self.encoded(name)},
            token=token, timeout=timeout,
            idempotency_key=f"adapter-load-{name}-{uuid.uuid4().hex[:8]}")

    def evict_adapter(self, replica_url: str, name: str,
                      token: Optional[str] = None,
                      timeout: float = DEFAULT_PUSH_TIMEOUT) -> dict:
        """Evict *name* from one replica. 409 (the adapter is pinned by a
        live request) raises ``urllib.error.HTTPError``: eviction waits for
        the stream, never yanks it. The replica's evict is name-idempotent
        (False when already gone), so a re-executed retry is harmless."""
        return request_json(
            replica_url.rstrip("/") + "/adapters",
            {"action": "evict", "name": name},
            token=token, timeout=timeout,
            idempotency_key=f"adapter-evict-{name}-{uuid.uuid4().hex[:8]}")
