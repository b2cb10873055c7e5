"""Multi-LoRA serving: N adapters over one base model in one batch (port of
``kubetpu/jobs/multi_lora.py``).

The base matmuls stay batched across every slot (one weight stream a step
whatever the tenant mix), while each slot's rank-r delta is a pair of
skinny per-example einsums against a stacked adapter tree (leaves
(N, L, ...)) gathered once a forward by a per-slot adapter-id tensor
(``decode.select_lora``): retargeting a slot writes an integer, never
weights. The deltas wrap around the attention, so every paged leg keeps
its kernel: the decode step's split route, each prefill chunk's wgmma
route (bf16 and int8 pools) and the speculative verify chunk. The ids
reach the card through pinned staging like the step's other host arrays,
so a dispatched step still makes no host sync.

Prefill runs the same chunk path with the stack, so every slot's greedy
output equals single-request decoding of ``lora.merge_lora(base,
adapter)`` (pinned by the tests against the JAX package's servers).

- ``MultiLoraDecodeServer``: ``DecodeServer`` (the contiguous cache) over
  a ready stack (``stack_adapters``).
- ``PagedMultiLoraDecodeServer`` / ``SpecMultiLoraDecodeServer``: the
  paged and the speculative paged servers with an adapter directory.

Two multi-tenant rules ride along on the paged servers:

- PREFIX ISOLATION: the radix tree's keys are salted with the slot's
  adapter id and that index's eviction generation (``_prefix_tokens``:
  token -> ((gen * capacity + aid + 1) << 32) | token, Python ints,
  length-preserving so the page math is unchanged) at every tree
  touchpoint: match, publish, host-tier fill. Adapter A's cached KV never
  warm-starts adapter B, and a tenant hot-loaded into a recycled index
  never warm-starts from the evicted occupant's pages. The chunk forward
  still reads the unsalted prompt.
- HOT LOAD/EVICT: the stack has a fixed capacity (``max_adapters`` / the
  ``adapter_hbm_bytes`` budget), allocated once. ``load_adapter`` writes a
  new adapter's factors into a free or LRU-evicted index in place
  (``copy_`` on the server's stream, so the write is ordered after any
  queued step), content-hashed (a replayed load is a no-op);
  ``evict_adapter`` refuses while a live request references the index;
  requests resolve adapters by name at enqueue. ``load_info`` advertises
  the resident set for tenant-affine routing.

The stack is held in the model's dtype (a bf16 model serves bf16 factors:
torch does not mix dtypes in a matmul); an adapter's name is the
fingerprint of the tree as given.

Over a mesh (``mesh=``, through the base servers) every rank holds its
slices of the stack (``lora.shard_lora`` by ``lora.lora_param_specs``, cut
at upload and at every hot load), so each rank's deltas run on its heads;
``wo``'s delta is summed with ``wo``'s partial output over tp. Every
upload and bind happens on every rank: they are host calls every rank
receives.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kubetpu_torch.jobs.lora import _MLP_TARGETS, LoraConfig, shard_lora
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer
from kubetpu_torch.router.migration import encode_array

# the targets the decode legs apply per example
_DECODE_TARGETS = ("wq", "wk", "wv", "wo")

# bounded tenant-series cardinality: the first K distinct adapters get
# their own {adapter=} label; the rest share the overflow label
_TENANT_TOPK = 32
_TENANT_OVERFLOW = "_overflow"

_TENANT_METRICS = {
    "req": "kubetpu_tenant_requests_total",
    "tok": "kubetpu_tenant_decode_tokens_total",
    "saved": "kubetpu_tenant_prefill_tokens_saved_total",
}


def _leaf_tensor(v) -> torch.Tensor:
    """An adapter leaf (a tensor, or a numpy array as the wire decodes
    f32 leaves) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(v))


def stack_adapters(lcfg: LoraConfig, adapters: Sequence[dict],
                   device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """Stack per-adapter trees (``lora.init_lora_params`` layout) into one
    tree with a leading adapter axis, leaves (N, L, ...), on *device* (the
    first adapter's by default) in *dtype* (its dtype by default).
    Validation runs over the adapters' actual keys, not
    ``lcfg.targets``: the decode legs apply the attention targets only
    (the MLP branch has no per-example plumbing), and a stacked target
    they cannot apply would silently break the merged-parity contract."""
    if not adapters:
        raise ValueError("need at least one adapter")
    keys = sorted(adapters[0]["blocks"])
    targets = {k.rsplit("_", 1)[0] for k in keys}
    bad = sorted(targets - set(_DECODE_TARGETS))
    if bad:
        hint = ("cannot be applied per-example in the decode path"
                if set(bad) & set(_MLP_TARGETS)
                else "is not a LoRA attention target")
        raise ValueError(
            f"multi-LoRA serving supports attention targets only; {bad} "
            f"{hint}")
    for a in adapters[1:]:
        if sorted(a["blocks"]) != keys:
            raise ValueError("adapters disagree on targets")
    first = _leaf_tensor(adapters[0]["blocks"][keys[0]])
    device = first.device if device is None else torch.device(device)
    dtype = dtype or first.dtype
    return {"blocks": {
        k: torch.stack([_leaf_tensor(a["blocks"][k]).to(device=device,
                                                        dtype=dtype)
                        for a in adapters]) for k in keys}}


def adapter_fingerprint(adapter: dict) -> str:
    """Content hash of one adapter tree, the registry and hot-load
    identity, equal to the JAX package's for the same bytes: sha256 over
    the sorted keys, each key, ``repr((shape, dtype))`` and the raw bytes
    (bf16 leaves as their 16-bit patterns under ``'bfloat16'``, as numpy
    prints the ml_dtypes type)."""
    h = hashlib.sha256()
    for k in sorted(adapter["blocks"]):
        v = adapter["blocks"][k]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        spec, raw = encode_array(k, v)
        h.update(k.encode())
        h.update(repr((tuple(spec["shape"]), spec["dtype"])).encode())
        h.update(raw)
    return h.hexdigest()[:16]


class _MultiLoraHostMixin:
    """The host half of multi-tenant serving, shared by every cache layout:
    per-request adapter plumbing (submit/enqueue -> ``_rid_adapter`` ->
    ``_bind_slot`` -> the per-slot id array the device legs gather by),
    the ``_admit_lora`` / ``_step_lora`` hooks, and the bounded-cardinality
    per-tenant counters. Subclasses call ``_init_multi_lora`` before their
    ``super().__init__`` (the base constructor builds legs that read the
    scale) and ``_init_lora_slots`` after it (``n_slots`` and the registry
    exist then)."""

    def _init_multi_lora(self, lcfg: LoraConfig, lora_stack: dict,
                         mesh=None) -> None:
        self.n_adapters = next(iter(lora_stack["blocks"].values())).shape[0]
        self._lora_scale = lcfg.scale
        self._lora_mesh = mesh
        if mesh is not None:
            lora_stack = shard_lora(lora_stack, mesh, stacked=True)
        self.lora_stack = lora_stack
        self._rid_adapter: Dict[int, int] = {}
        self._submit_adapter: Optional[int] = None

    def _init_lora_slots(self) -> None:
        self._slot_adapter = np.zeros((self.n_slots,), np.int64)
        # {kind: {label: counter}}: one series per top-K adapter plus the
        # shared overflow label
        self._tenant_counters: Dict[str, dict] = {k: {}
                                                  for k in _TENANT_METRICS}

    # -- request surface ------------------------------------------------------

    def _check_adapter(self, adapter) -> int:
        if not isinstance(adapter, (int, np.integer)):
            raise ValueError(f"adapter must be an index, got {adapter!r}")
        if not 0 <= adapter < self.n_adapters:
            raise ValueError(
                f"adapter {adapter} out of range [0, {self.n_adapters})")
        return int(adapter)

    def _adapter_label(self, aid: int) -> str:
        return str(int(aid))

    def _tenant_counter(self, kind: str, aid: int):
        cache = self._tenant_counters[kind]
        label = self._adapter_label(aid)
        if label not in cache and len(cache) >= _TENANT_TOPK:
            label = _TENANT_OVERFLOW
        if label not in cache:
            cache[label] = self.obs.counter(_TENANT_METRICS[kind],
                                            adapter=label)
        return cache[label]

    def submit(self, prompt: List[int], sampling: Optional[dict] = None,
               adapter=0) -> Optional[int]:
        aid = self._check_adapter(adapter)
        self._submit_adapter = aid
        try:
            rid = super().submit(prompt, sampling)
        finally:
            self._submit_adapter = None
        if rid is not None:
            self._tenant_counter("req", aid).inc()
        return rid

    def enqueue(self, prompt: List[int], sampling: Optional[dict] = None,
                adapter=0, ttl: Optional[float] = None) -> int:
        aid = self._check_adapter(adapter)   # before any bookkeeping
        rid = super().enqueue(prompt, sampling, ttl=ttl)
        self._rid_adapter[rid] = aid
        self._tenant_counter("req", aid).inc()
        return rid

    def _bind_slot(self, rid: int, slot: int) -> None:
        # both admission paths (monolithic and chunked) bind here, so a
        # chunked prefill applies the right adapter from its first chunk
        if rid not in self._rid_adapter:     # submit: the rid is new
            self._rid_adapter[rid] = (
                0 if self._submit_adapter is None else self._submit_adapter)
        self._slot_adapter[slot] = self._rid_adapter[rid]
        super()._bind_slot(rid, slot)

    def _drop_request_state(self, rid: int) -> None:
        # the adapter map's reclamation point: the base calls this from
        # pop_result, cancel, the queue-TTL expiry and a refused submit,
        # so no entry outlives its request (and a dead rid cannot pin an
        # adapter index against eviction forever)
        self._rid_adapter.pop(rid, None)
        super()._drop_request_state(rid)

    def _note_emitted(self, slot: int) -> None:
        super()._note_emitted(slot)
        self._tenant_counter("tok", int(self._slot_adapter[slot])).inc()

    def adapters_in_use(self) -> set:
        """Adapter indices referenced by any live (queued, active, or
        finished-but-unpopped) request: the eviction guard's read."""
        return set(int(a) for a in self._rid_adapter.values())

    # -- the hooks the device legs consume ------------------------------------

    def _admit_lora(self, slot: int):
        return self.lora_stack, self._upload(
            self._slot_adapter[slot:slot + 1])

    def _step_lora(self):
        return self.lora_stack, self._upload(self._slot_adapter)


class MultiLoraDecodeServer(_MultiLoraHostMixin, DecodeServer):
    """``DecodeServer`` where every request picks an adapter from a shared
    stack (``stack_adapters``, on the server's device in the model's
    dtype): ``submit(prompt, adapter=i)`` / ``enqueue(prompt,
    adapter=i)`` (default adapter 0)."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 lcfg: LoraConfig, lora_stack: dict, **kw) -> None:
        device = resolve_device(kw.get("device"))
        stack = {"blocks": {k: v.to(device=device, dtype=cfg.dtype)
                            for k, v in lora_stack["blocks"].items()}}
        self._init_multi_lora(lcfg, stack, kw.get("mesh"))
        super().__init__(cfg, params, **kw)
        self._init_lora_slots()


class _PagedMultiLoraMixin(_MultiLoraHostMixin):
    """The paged half of multi-tenant serving, shared by the plain paged
    and the speculative multi-LoRA servers: the fixed-capacity hot-load /
    evict adapter directory, adapter-salted prefix-tree keys, per-tenant
    prefill-savings attribution and the router-facing residency
    advertisement. Subclasses call ``_init_paged_lora`` before their
    ``super().__init__``."""

    def _init_paged_lora(self, cfg: ModelConfig, lcfg: LoraConfig,
                         adapters: Sequence[dict], kw: dict,
                         max_adapters: Optional[int],
                         adapter_hbm_bytes: int) -> None:
        device = resolve_device(kw.get("device"))
        stack = stack_adapters(lcfg, adapters, device=device,
                               dtype=cfg.dtype)
        n = len(adapters)
        self._adapter_bytes_each = sum(
            v.numel() * v.element_size()
            for v in stack["blocks"].values()) // n
        cap = int(max_adapters) if max_adapters else n
        if adapter_hbm_bytes > 0:
            by_budget = max(1, int(adapter_hbm_bytes
                                   // max(self._adapter_bytes_each, 1)))
            cap = min(cap, by_budget) if max_adapters else by_budget
        if cap < n:
            raise ValueError(
                f"adapter capacity {cap} (max_adapters/adapter_hbm_bytes) "
                f"cannot hold the {n} initial adapters")
        if cap > n:
            # pad to capacity with zero factors (zero delta: the base
            # model); capacity is fixed here once, a hot load writes into
            # an index and never reallocates
            stack = {"blocks": {
                k: torch.cat([v, v.new_zeros((cap - n,) + v.shape[1:])])
                for k, v in stack["blocks"].items()}}
        self._init_multi_lora(lcfg, stack, kw.get("mesh"))
        self._adapter_names: List[Optional[str]] = [None] * cap
        self._resident: Dict[str, int] = {}
        self._adapter_lru = [0] * cap
        # per-index generation, bumped on evict: prefix keys are salted
        # with (gen, index), so a tenant hot-loaded into a recycled index
        # never warm-starts from the previous occupant's cached pages
        self._adapter_gen = [0] * cap
        self._lru_tick = 0
        for i, a in enumerate(adapters):
            name = adapter_fingerprint(a)
            self._adapter_names[i] = name
            self._resident[name] = i

    def _init_adapter_obs(self) -> None:
        self._init_lora_slots()
        self.obs.gauge_fn("kubetpu_adapters_resident",
                          lambda: len(self._resident))
        self.obs.gauge_fn("kubetpu_adapter_capacity",
                          lambda: self.n_adapters)
        self.obs.gauge_fn("kubetpu_adapter_stack_bytes",
                          lambda: self._adapter_bytes_each * self.n_adapters)
        self._c_adapter_loads = self.obs.counter(
            "kubetpu_adapter_loads_total",
            "adapters hot-loaded into the device stack (replayed loads "
            "of a resident adapter are NOT counted — idempotent)")
        self._c_adapter_evicts = self.obs.counter(
            "kubetpu_adapter_evicts_total",
            "adapters evicted from the device stack (explicit + LRU)")

    # -- adapter directory: hot load / evict ----------------------------------

    def _check_adapter(self, adapter) -> int:
        if isinstance(adapter, str):
            idx = self._resident.get(adapter)
            if idx is None:
                raise ValueError(f"adapter {adapter!r} is not resident")
            return idx
        idx = super()._check_adapter(adapter)
        if self._adapter_names[idx] is None:
            raise ValueError(
                f"adapter index {idx} is empty (never loaded, or evicted)")
        return idx

    def _adapter_label(self, aid: int) -> str:
        name = self._adapter_names[int(aid)]
        return name if name is not None else str(int(aid))

    def _touch_adapter(self, idx: int) -> None:
        self._lru_tick += 1
        self._adapter_lru[idx] = self._lru_tick

    def _bind_slot(self, rid: int, slot: int) -> None:
        super()._bind_slot(rid, slot)
        self._touch_adapter(int(self._slot_adapter[slot]))

    def _live_indices(self) -> set:
        """Indices a live request or an active slot references."""
        in_use = self.adapters_in_use()
        in_use.update(int(self._slot_adapter[s])
                      for s in range(self.n_slots) if self.active[s])
        return in_use

    @torch.no_grad()
    def load_adapter(self, adapter: dict, name: Optional[str] = None) -> str:
        """Hot-load one adapter tree (leaves tensors or numpy arrays, the
        stack's shapes) into the device stack and return its name (by
        default the content fingerprint, the wire identity). Idempotent: a
        resident name is a no-op returning the same name. Under a full
        stack the least-recently-bound adapter no live request references
        is evicted to make room; with every index in use the load refuses
        (RuntimeError, the wire layer's retryable 503). The factors are
        written in place on the server's stream (ordered after any queued
        step) and never reallocated. A barrier leg, never called from
        inside ``step()``."""
        name = name or adapter_fingerprint(adapter)
        if name in self._resident:
            self._touch_adapter(self._resident[name])
            return name
        keys = sorted(self.lora_stack["blocks"])
        if sorted(adapter["blocks"]) != keys:
            raise ValueError(
                f"adapter targets {sorted(adapter['blocks'])} do not match "
                f"the stack's {keys}")
        if self._lora_mesh is not None:
            # this rank's slices of the adapter, as the stack holds them
            adapter = shard_lora(
                {"blocks": {k: _leaf_tensor(v)
                            for k, v in adapter["blocks"].items()}},
                self._lora_mesh)
        for k in keys:
            want = tuple(self.lora_stack["blocks"][k].shape[1:])
            got = tuple(adapter["blocks"][k].shape)
            if got != want:
                raise ValueError(
                    f"adapter leaf {k!r} shape {got} != stack's {want}")
        idx = self._free_adapter_index()
        for k in keys:
            self.lora_stack["blocks"][k][idx].copy_(
                _leaf_tensor(adapter["blocks"][k]))
        self._adapter_names[idx] = name
        self._resident[name] = idx
        self._touch_adapter(idx)
        self._c_adapter_loads.inc()
        self.events.emit("adapter_load", name=name, index=idx,
                         resident=len(self._resident))
        return name

    def _free_adapter_index(self) -> int:
        for i, nm in enumerate(self._adapter_names):
            if nm is None:
                return i
        in_use = self._live_indices()
        evictable = [i for i, nm in enumerate(self._adapter_names)
                     if nm is not None and i not in in_use]
        if not evictable:
            raise RuntimeError(
                "adapter stack full and every index is referenced by a "
                "live request — retry after requests drain")
        victim = min(evictable, key=lambda i: self._adapter_lru[i])
        self._evict_index(victim, reason="lru")
        return victim

    def _evict_index(self, idx: int, reason: str) -> None:
        name = self._adapter_names[idx]
        self._adapter_names[idx] = None
        self._resident.pop(name, None)
        # retire every prefix key this index published: the next occupant
        # salts under gen+1, so the old tenant's cached pages are
        # unreachable (they age out of the tree through its own LRU)
        self._adapter_gen[idx] += 1
        self._c_adapter_evicts.inc()
        self.events.emit("adapter_evict", name=name, index=idx,
                         reason=reason)

    def evict_adapter(self, name: str) -> bool:
        """Evict *name* from the directory (its factors stay in the stack
        until the index is reused, unreachable: requests resolve names at
        enqueue). False when not resident (a replayed evict is a no-op);
        RuntimeError while a live request references the index (the wire
        layer's 409)."""
        idx = self._resident.get(name)
        if idx is None:
            return False
        if idx in self._live_indices():
            raise RuntimeError(
                f"adapter {name!r} is referenced by a live request")
        self._evict_index(idx, reason="explicit")
        return True

    def resident_adapters(self) -> List[str]:
        """Names of the loaded adapters: what ``load_info`` advertises for
        tenant-affine routing."""
        return sorted(self._resident)

    def load_info(self) -> dict:
        info = super().load_info()
        info["resident_adapters"] = self.resident_adapters()
        info["adapter_capacity"] = self.n_adapters
        return info

    def check_invariants(self) -> None:
        """The pool oracle plus the adapter directory's: every resident
        name owns exactly one stack index, every named index is resident,
        and no live slot points at an unnamed (evicted) index.
        AssertionError on a violation."""
        super().check_invariants()
        named = {i for i, n in enumerate(self._adapter_names)
                 if n is not None}
        assert len(self._resident) == len(named), (
            f"directory skew: {len(self._resident)} resident names over "
            f"{len(named)} named indices")
        for name, idx in self._resident.items():
            assert self._adapter_names[idx] == name, (
                f"adapter {name!r} maps to index {idx} which is named "
                f"{self._adapter_names[idx]!r}")
        assert len(set(self._resident.values())) == len(self._resident), (
            "two resident names share a stack index")
        for s in range(self.n_slots):
            if self.active[s]:
                aid = int(self._slot_adapter[s])
                assert 0 <= aid < self.n_adapters
                assert self._adapter_names[aid] is not None, (
                    f"live slot {s} decodes under evicted index {aid}")

    # -- adapter-keyed prefix isolation ---------------------------------------

    def _prefix_tokens(self, prompt: List[int], slot: int) -> List[int]:
        """The prompt salted with the slot's (generation, adapter id) for
        every prefix-tree touchpoint: 64-bit Python ints, never cast to
        int32; length-preserving (page math unchanged). aid + 1 keeps
        adapter 0 disjoint from any unsalted key a peer replica might
        ship, and the eviction generation keeps a recycled index disjoint
        from its previous occupant's keys."""
        aid = int(self._slot_adapter[slot])
        salt = (self._adapter_gen[aid] * self.n_adapters + aid + 1) << 32
        return [salt | (int(t) & 0xFFFFFFFF) for t in prompt]

    def _prefill_start(self, prompt: List[int], slot: int) -> int:
        # match (and host-tier fill) under the adapter-salted key: a hit
        # maps only pages whose KV this adapter's wk/wv deltas computed
        return super()._prefill_start(self._prefix_tokens(prompt, slot),
                                      slot)

    def _note_admitted(self, slot: int, prompt: List[int]) -> None:
        pending = self._slot_pending_stats[slot]
        super()._note_admitted(slot, prompt)
        # the publication key: the tree files this slot's pages under the
        # adapter that computed them
        self._slot_prompt[slot] = self._prefix_tokens(prompt, slot)
        if pending is not None and pending[1] > 0:
            self._tenant_counter(
                "saved", int(self._slot_adapter[slot])).inc(pending[1])

    # -- live migration -------------------------------------------------------

    def snapshot_slot(self, rid: int, from_page: int = 0,
                      allow_frozen: bool = False) -> dict:
        # a snapshot carries no adapter identity, and the target's
        # directory may not hold this tenant: a resumed stream under the
        # wrong adapter would be a silent cross-tenant leak. The wire
        # layer treats NotImplementedError as a per-stream skip.
        raise NotImplementedError(
            "multi-LoRA slots do not migrate — the snapshot carries no "
            "adapter identity; drain instead")

    def restore_slot(self, snap: dict, reason: str = "migrate"):
        raise NotImplementedError(
            "multi-LoRA replicas do not accept migrated slots — the "
            "snapshot carries no adapter identity")


class PagedMultiLoraDecodeServer(_PagedMultiLoraMixin, PagedDecodeServer):
    """``PagedDecodeServer`` serving N tenants from one packed replica:
    ``submit/enqueue(prompt, adapter=index_or_name)`` picks from the
    stacked device tree; the per-slot ids ride pinned uploads into the
    paged legs, so chunked prefill, int8 pools, prefix hits and the paged
    kernels serve every tenant mix, greedy-token-exact against
    ``merge_lora`` single-tenant decode. See ``_PagedMultiLoraMixin`` for
    hot load / evict and the salted prefix keys. ``device`` defaults to
    the card and raises without CUDA."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 lcfg: LoraConfig, adapters: Sequence[dict],
                 max_adapters: Optional[int] = None,
                 adapter_hbm_bytes: int = 0, **kw) -> None:
        self._init_paged_lora(cfg, lcfg, adapters, kw, max_adapters,
                              adapter_hbm_bytes)
        super().__init__(cfg, params, **kw)
        self._init_adapter_obs()


class SpecMultiLoraDecodeServer(_PagedMultiLoraMixin,
                                PagedSpeculativeDecodeServer):
    """Speculative draft+verify rounds over the packed multi-LoRA pool: the
    target's verify chunk applies each slot's adapter, the draft runs
    without adapters (a base-model draft can only lower acceptance, never
    change the output, because verification is greedy-exact). Output is
    token-identical to ``PagedMultiLoraDecodeServer``'s greedy stream."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 target_params: Transformer, draft_params: Transformer,
                 lcfg: LoraConfig, adapters: Sequence[dict],
                 max_adapters: Optional[int] = None,
                 adapter_hbm_bytes: int = 0, **kw) -> None:
        self._init_paged_lora(target_cfg, lcfg, adapters, kw, max_adapters,
                              adapter_hbm_bytes)
        super().__init__(target_cfg, draft_cfg, target_params, draft_params,
                         **kw)
        self._init_adapter_obs()
