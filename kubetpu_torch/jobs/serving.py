"""Continuous batching: the host-side request lifecycle over a fixed batch of
slots (port of ``SlotServerBase``, ``kubetpu/jobs/serving.py:118-1262``).

Requests enter and leave slots without stopping the batch. ``enqueue`` is
host bookkeeping only; a queued request is admitted at the next ``step``
boundary, and its first token is fetched after that step's decode has been
queued, so the admission does not serialize the batch. With
``prefill_budget > 0`` each ``step`` spends at most that many prompt tokens
on page-aligned prefill chunks (resuming in-flight prefills first), so a
long prompt never stalls decoding for more than one bounded chunk; prompts
pad to power-of-two buckets. Sampling is request-deterministic: a request's
draw at position q is seeded from (seed, rid, q - 1) only.

Host state (positions, occupancy, per-slot sampling settings) lives in
numpy; the last emitted tokens stay on the device between steps. A
subclass provides the device legs: ``_admit_device``,
``_prefill_chunk_device`` and ``_device_step``.

Observability is host bookkeeping only: one ``obs.registry.Registry`` per
server (latency summaries for admission stall, step, prefill chunk, TTFT,
inter-token latency and queue wait; occupancy gauges evaluated at render),
rendered by ``metrics_text()`` with the JAX package's series names, and a
bounded ``EventLog`` of admissions, retirements, cancels and expiries.
``queue_ttl`` bounds a queued request's wait: past it the request finishes
empty with a reason.

Live migration's host half (``kubetpu/jobs/serving.py:1006-1186``): which
streams may move (``migratable_rids``, ``prefill_progress``), the pause
around a wire handoff (``freeze_slot`` / ``unfreeze_slot``), how a stream
that moved away finishes here (``finish_migrated``, ``migrated_to``), and
the request-state half of a snapshot (``_snapshot_request`` /
``_restore_request``); the page half is the paged server's.

``overlap=True`` double-buffers the host loop: ``step()`` dispatches step
N (``_dispatch_step``, which makes no host sync) before it routes step N-1's
tokens (``_route_step``, the step's one sync), so the card runs one step
ahead of token routing. Emission, and with it EOS and length retirement,
lags one step; a retired slot's one in-flight token is discarded by the
dispatch-time snapshot, and the stray cache write it made lands where the
next occupant writes before any read. ``drain()`` flushes the tail. Host
arrays reach the card through pinned staging buffers, so an upload does
not wait for the queued work either.

``DecodeServer`` is the contiguous-cache sibling of the paged server: one
(L, n_slots, S_max, H_kv, D) cache, dense or int8 (``kv_int8``), with the
device legs of ``_build_dense_legs`` (a prefill chunk of one slot through
``decode.forward_chunk_io``, and the all-slot step through
``decode.forward_chunk_at_io``). The speculative servers draft on the same
dense cache.

Over a mesh (``mesh=``, a ``meshjob`` DeviceMesh over dp and tp) a server
is SPMD, one process a rank: every rank builds the same server and
receives the same calls (``submit``, ``enqueue``, ``step``, ``drain``, the
migration legs), every rank runs the whole host scheduler (admission,
buckets, pages, the prefix tree), and the device work is sharded. The
parameters are cut by ``train.param_specs`` (``train.shard_model``; a
model that already is a shard of the mesh, ``train.init_shard``'s, is
taken as it is, so no rank need ever hold the whole model), the blocks
run tensor-parallel, and the logits reach every rank of a tp group
whole, so every rank samples the same tokens. ``DecodeServer`` puts slots
on dp when dp divides ``n_slots`` (a rank runs its own slots' legs and
each step's tokens, and each prefill's first token, are shared over dp
before routing); the paged servers replicate the pool over dp, as the
JAX package does. No decision may read a clock: a meshed server refuses
``queue_ttl`` (and ``enqueue``'s ``ttl``), whose expiry would differ
between ranks and leave one rank a step its peers never take;
``check_lockstep`` compares every rank's host state by digest.

The signal layer is the JAX package's, off by default: ``declare_slos``
attaches an SLO engine (``obs.slo``) over the server's registry, evaluated
from inside ``step()``, and ``enable_profiler`` the sampled profiler
(``obs.profile``): every Nth step is split into schedule / dispatch /
device / materialize, the device phase waiting on that step's own host
copy event, and the device legs are watched for first calls. Un-sampled
steps, and a server without a profiler, make no more host syncs than
before.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubetpu_torch.core.metrics import LatencyRecorder
from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs.decode import (_dense_cache_io, _int8_cache_io,
                                       _rows, forward_chunk_at_io,
                                       forward_chunk_io, init_kv_cache,
                                       init_kv_cache_int8)
from kubetpu_torch.jobs.model import (ModelConfig, Transformer,
                                      resolve_device)
from kubetpu_torch.jobs.sampling import (chosen_logprob, make_slot_sampler,
                                         row_seed)
from kubetpu_torch.obs.events import EventLog
from kubetpu_torch.obs.profile import ServingProfiler
from kubetpu_torch.obs.registry import Registry, install_process_gauges
from kubetpu_torch.obs.slo import Objective, SloEngine


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of host array *a* on *device*. For the card it is staged in
    pinned memory and copied without waiting for the device's queue (a
    copy from pageable memory would wait for it); the caching host
    allocator keeps the staging buffer until the copy has run."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    staged = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
    return staged.to(device, non_blocking=True)


def _stage_to_host(t: torch.Tensor):
    """Queue the copy of device tensor *t* to the host without waiting: on
    the card into a pinned buffer, with an event recorded after the copy,
    so that a later wait covers this copy and nothing queued after it; on
    the CPU the tensor itself. ``_host_values`` reads it back."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _wait_staged(staged) -> None:
    """Wait until a ``_stage_to_host`` copy has landed (its own event on
    the card; nothing to wait for on the CPU)."""
    done = staged[1]
    if done is not None:
        done.synchronize()


def _host_values(staged) -> np.ndarray:
    """The values of a ``_stage_to_host`` copy, as numpy: the one host
    sync (waiting on the copy's event on the card)."""
    t, done = staged
    if done is None:
        return t.cpu().numpy()
    done.synchronize()
    return t.numpy()


class SlotServerBase:
    """Host-side continuous-batching lifecycle over ``n_slots`` slots.

    Subclass contract:
    - ``_admit_device(prompt, slot) -> Optional[(token, logprob)]``: reserve
      resources and prefill the whole prompt; the first token and its
      raw-distribution logprob as device scalars, or None when resources
      are unavailable (nothing mutated; the request stays queued);
    - ``_prefill_chunk_device(prompt, slot, pos, take, final) -> None |
      True | (token, logprob)``: prefill ``prompt[pos:pos+take]`` at
      ``pos`` (``final`` samples the first token);
    - ``_device_step() -> (tokens, logprobs)`` device tensors (n_slots,):
      one decode step for all slots, queued without a host sync (the base
      routes, and with ``overlap`` defers, the host copy);
    - optional hooks ``_prefill_start(prompt, slot)``, ``_note_admitted(
      slot, prompt)``, ``_note_emitted(slot)`` and ``_on_retire(slot)``;
    - the multi-LoRA hooks ``_admit_lora(slot)`` / ``_step_lora()`` (the
      adapter pair every device leg takes) and ``_drop_request_state(
      rid)`` (per-request bookkeeping, dropped on every exit path).
    """

    _min_bucket = 1

    def __init__(self, cfg: ModelConfig, params: Transformer, n_slots: int,
                 max_seq: int, max_new_tokens: int, eos_id: Optional[int],
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 prefill_budget: int = 0, overlap: bool = False,
                 queue_ttl: Optional[float] = None, device=None,
                 mesh=None) -> None:
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.mesh = mesh
        self._groups = None
        if mesh is not None:
            self._groups = _serving_groups(cfg, mesh)
            if queue_ttl is not None:
                raise ValueError(
                    "a meshed server refuses queue_ttl: an expiry read off "
                    "each rank's clock would differ between ranks, and a "
                    "rank that skipped a step would wait in a collective "
                    "its peers never enter")
            from kubetpu_torch.jobs.train import shard_model

            self.params = shard_model(params, cfg, mesh)
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if top_k is not None and top_k <= 0:
            raise ValueError("top_k must be positive (or None)")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 = monolithic)")
        self._default_sampling = (
            float(temperature), int(top_k or 0), float(top_p or 1.0))
        self._slot_temp = np.full((n_slots,), temperature, np.float32)
        self._slot_topk = np.full((n_slots,), top_k or 0, np.int64)
        self._slot_topp = np.full((n_slots,), top_p or 1.0, np.float32)
        self._rid_sampling: Dict[int, Tuple[float, int, float]] = {}
        self.seed = int(seed)
        self._slot_reqkey: List[int] = [0] * n_slots
        self.prefill_budget = int(prefill_budget)
        self.overlap = bool(overlap)
        # token-budget scheduler state: slot -> in-flight prefill progress
        self._prefills: Dict[int, dict] = {}
        self._prefill_fifo: List[int] = []
        self._inflight = None          # overlap: the step not yet routed
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id

        self.pos = np.zeros((n_slots,), np.int64)      # index of `last`
        self.last = torch.zeros((n_slots,), dtype=torch.int64,
                                device=self.device)    # last emitted token
        self.active = np.zeros((n_slots,), bool)

        self._next_rid = 0
        self._slot_rid: List[Optional[int]] = [None] * n_slots
        self._prompts: Dict[int, List[int]] = {}
        self._emitted: Dict[int, List[int]] = {}
        self._logprobs: Dict[int, List[float]] = {}
        self._done: Dict[int, bool] = {}
        # admission queue entries: (rid, prompt, deadline or None); a queued
        # prompt past its deadline is expired (finished empty, reason kept)
        if queue_ttl is not None and queue_ttl < 0:
            raise ValueError("queue_ttl must be >= 0 (None = no deadline)")
        self.queue_ttl = queue_ttl
        self._queue: List[Tuple[int, List[int], Optional[float]]] = []
        self._expired: Dict[int, str] = {}     # rid -> reason
        self._pending_first: Dict[int, tuple] = {}     # slot -> staged copy
        # live migration: slots frozen mid-handoff (inactive for the step
        # legs but not reusable), streams that finished here by migrating
        # away (rid -> the new owner the wire layer reports instead of
        # tokens), and each stream's handoff identity: (origin replica,
        # origin rid) and the epoch the target's fence compares
        self._frozen: set = set()
        self._migrated: Dict[int, dict] = {}
        self._stream_epoch: Dict[int, int] = {}
        self._stream_origin: Dict[int, tuple] = {}
        # observability: every latency this server records lives in one
        # registry (``metrics_text``); occupancy gauges are evaluated at
        # render, so the hot loop pays nothing for them
        self.obs = Registry()
        install_process_gauges(self.obs, "serving")
        self.events = EventLog(component="serving")
        # the sampled profiler and the SLO engine, both off by default
        # (``enable_profiler`` / ``declare_slos``): while off they cost
        # one ``is not None`` check a step, no sync, no upload
        self._profiler: Optional[ServingProfiler] = None
        self.slo: Optional[SloEngine] = None
        self._slo_interval = 1.0
        self._metrics = LatencyRecorder(
            registry=self.obs, metric="kubetpu_serving_latency_seconds")
        self.obs.gauge_fn("kubetpu_serving_active_slots",
                          lambda: int(self.active.sum()))
        self.obs.gauge_fn("kubetpu_serving_slots", lambda: self.n_slots)
        self.obs.gauge_fn("kubetpu_serving_queue_depth",
                          lambda: len(self._queue))
        self.obs.gauge_fn("kubetpu_serving_inflight_prefills",
                          lambda: len(self._prefills))
        self._arrive: Dict[int, float] = {}    # rid -> arrival perf stamp
        self._last_emit: Dict[int, float] = {}  # rid -> last emission stamp
        self._qw_recorded: set = set()         # rids with a queue_wait sample

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host array *a* on the server's device, queued without a
        host sync (``to_device``)."""
        return to_device(a, self.device)

    def _request_key(self, rid: int) -> int:
        return row_seed(self.seed, rid)

    def _slot_sampling(self, slot: int) -> Tuple[float, int, float]:
        return (float(self._slot_temp[slot]), int(self._slot_topk[slot]),
                float(self._slot_topp[slot]))

    def _bind_slot(self, rid: int, slot: int) -> None:
        """Point the slot's sampling settings and request key at *rid*,
        before any device leg touches the slot."""
        temp, tk, tp = self._rid_sampling.get(rid, self._default_sampling)
        self._slot_temp[slot] = temp
        self._slot_topk[slot] = tk
        self._slot_topp[slot] = tp
        self._slot_reqkey[slot] = self._request_key(rid)

    # -- multi-LoRA hooks (the multi_lora servers override them) -------------
    #
    # Every device leg takes a (stacked adapter tree, adapter ids) pair; the
    # plain servers pass (None, None), and no LoRA op runs.

    _lora_scale = 1.0     # alpha / rank of the multi-LoRA servers' stack

    def _admit_lora(self, slot: int):
        """(adapter stack, the slot's adapter id (1,) on the device) for an
        admission's prefill chunks: none here."""
        return None, None

    def _step_lora(self):
        """(adapter stack, per-slot adapter ids (n_slots,) on the device)
        for a decode step: none here."""
        return None, None

    def _drop_request_state(self, rid: int) -> None:
        """Drop what the server keeps for *rid*'s admission and decoding:
        its sampling settings here, and a subclass's own maps (the
        multi-LoRA servers' adapter map). Called on every path a request's
        bookkeeping dies through: ``pop_result``, ``cancel`` (queued or
        admitted), the queue-TTL expiry and a refused ``submit``, so no
        entry outlives its request."""
        self._rid_sampling.pop(rid, None)

    def _free_slots(self) -> List[int]:
        """Slots holding neither an active decode nor an in-flight prefill
        nor a stream frozen mid-migration (inactive for the step legs, but
        its pages and bookkeeping are still live)."""
        return [i for i in range(self.n_slots)
                if not self.active[i] and i not in self._prefills
                and i not in self._frozen]

    # -- request lifecycle ---------------------------------------------------

    def _check_prompt(self, prompt: List[int]) -> None:
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + self.max_new_tokens + 1 > self.max_seq:
            raise ValueError("prompt + max_new_tokens exceeds max_seq")

    def _bucket(self, n: int) -> int:
        """Next power-of-two bucket from ``_min_bucket``, capped at
        ``max_seq``: a bounded set of prefill shapes serves every prompt."""
        bucket = self._min_bucket
        while bucket < n:
            bucket *= 2
        return min(bucket, self.max_seq)

    def _activate(self, rid: int, slot: int, prompt: List[int],
                  first) -> None:
        """Flip *slot* to decoding after its prompt's last chunk."""
        tok, _lp = first
        self.pos[slot] = len(prompt)
        self.last[slot] = tok
        self.active[slot] = True
        self._slot_rid[slot] = rid
        self._note_admitted(slot, prompt)

    def _try_admit(self, rid: int, prompt: List[int], slot: int,
                   defer: bool = False) -> bool:
        """Monolithic admission: whole-prompt prefill, timed as admission
        stall. With ``defer`` the first token stays on the device until the
        step's routing."""
        t0 = time.perf_counter()
        self._bind_slot(rid, slot)
        admitted = self._admit_device(prompt, slot)
        if admitted is None:
            return False
        self._record_queue_wait(rid, t0)
        self._activate(rid, slot, prompt, admitted)
        self._prompts[rid] = list(prompt)
        self._done[rid] = False
        # admit before any first-token retire: a request finishing on its
        # first token still logs admit -> retire in causal order
        self.events.emit("admit", rid=rid, slot=slot,
                         prompt_tokens=len(prompt), path="monolithic")
        if defer:
            self._emitted[rid] = []
            self._logprobs[rid] = []
            self._pending_first[slot] = self._stage_first(admitted)
        else:
            first, first_lp = admitted
            self._emitted[rid] = [int(first)]
            self._logprobs[rid] = [float(first_lp)]
            self._obs_tokens(rid, 1)
            self._retire_if_done(slot)
        self._metrics.record("admission_stall", time.perf_counter() - t0)
        return True

    def _normalize_sampling(
            self, sampling: Optional[dict]) -> Tuple[float, int, float]:
        if sampling is None:
            return self._default_sampling
        unknown = set(sampling) - {"temperature", "top_k", "top_p"}
        if unknown:
            raise ValueError(f"unknown sampling keys {sorted(unknown)}")
        d_temp, d_tk, d_tp = self._default_sampling
        tk = sampling.get("top_k", d_tk)
        tp = sampling.get("top_p", d_tp)
        temp, tk, tp = (float(sampling.get("temperature", d_temp)),
                        int(d_tk if tk is None else tk),
                        float(d_tp if tp is None else tp))
        if temp < 0:
            raise ValueError("temperature must be >= 0")
        if tk < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")
        if not 0.0 < tp <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        return temp, tk, tp

    def submit(self, prompt: List[int],
               sampling: Optional[dict] = None) -> Optional[int]:
        """Admit into a free slot now (whole prompt, on the caller's clock);
        None when no slot or not enough pool pages are free. *sampling*
        overrides the server defaults (temperature / top_k / top_p)."""
        self._check_prompt(prompt)
        free = self._free_slots()
        if not free:
            return None
        rid = self._next_rid
        self._rid_sampling[rid] = self._normalize_sampling(sampling)
        self._arrive[rid] = time.perf_counter()
        if not self._try_admit(rid, prompt, free[0]):
            self._drop_request_state(rid)
            del self._arrive[rid]
            return None
        self._next_rid += 1
        return rid

    def enqueue(self, prompt: List[int], sampling: Optional[dict] = None,
                ttl: Optional[float] = None) -> int:
        """Non-blocking admission: host bookkeeping only; the request enters
        a slot at a later ``step``. Always returns a request id. *ttl*
        (seconds, default the server's ``queue_ttl``) bounds the queue wait:
        past it the request finishes with no tokens and
        ``expire_reason(rid)`` says why."""
        self._check_prompt(prompt)
        if ttl is not None and self.mesh is not None:
            raise ValueError("a meshed server refuses a queue ttl (see "
                             "queue_ttl)")
        rid = self._next_rid
        self._next_rid += 1
        self._rid_sampling[rid] = self._normalize_sampling(sampling)
        self._arrive[rid] = time.perf_counter()
        self._prompts[rid] = list(prompt)
        self._emitted[rid] = []
        self._logprobs[rid] = []
        self._done[rid] = False
        if ttl is None:
            ttl = self.queue_ttl
        deadline = None if ttl is None else time.monotonic() + ttl
        self._queue.append((rid, list(prompt), deadline))
        return rid

    def queued(self) -> int:
        """Requests enqueued but not yet admitted to a slot."""
        return len(self._queue)

    def expire_reason(self, rid: int) -> Optional[str]:
        """Why a request was expired ("queue_ttl"), or None for requests
        that were admitted (or are still waiting)."""
        return self._expired.get(rid)

    def _expire_queue(self) -> None:
        """Drop queued requests past their deadline: they finish empty
        with a counted reason."""
        if not self._queue:
            return
        now = time.monotonic()
        keep = []
        for rid, prompt, deadline in self._queue:
            if deadline is not None and now >= deadline:
                self._done[rid] = True
                self._expired[rid] = "queue_ttl"
                self._drop_request_state(rid)
                self._arrive.pop(rid, None)  # no tokens ever: no TTFT
                self._metrics.record("queue_expired", now - deadline)
                self.events.emit("queue_expired", rid=rid)
            else:
                keep.append((rid, prompt, deadline))
        if len(keep) != len(self._queue):
            self._queue = keep

    def _record_queue_wait(self, rid: int, now: float) -> None:
        """One queue_wait sample per request, at its first admission start
        (a prefill parked back into the queue records no second one)."""
        arrived = self._arrive.get(rid)
        if arrived is None or rid in self._qw_recorded:
            return
        self._qw_recorded.add(rid)
        self._metrics.record("queue_wait", now - arrived)

    def _obs_tokens(self, rid: int, n: int) -> None:
        """One emission event for *rid* (*n* tokens): the first records
        TTFT (arrival -> first token, host wall time), later ones the
        inter-token latency, normalized by the event's token count."""
        now = time.perf_counter()
        last = self._last_emit.get(rid)
        if last is None:
            arrived = self._arrive.get(rid)
            if arrived is not None:
                self._metrics.record("ttft", now - arrived)
        elif n > 0:
            self._metrics.record("itl", (now - last) / n)
        self._last_emit[rid] = now

    def metrics_summary(self) -> dict:
        """{op: {p50_ms, p90_ms, p99_ms, count}} for admission_stall, step,
        prefill_chunk, ttft, itl, queue_wait (and queue_expired once a TTL
        has expired a request): the histograms ``metrics_text`` renders."""
        return self._metrics.summary()

    def metrics_text(self) -> str:
        """Prometheus exposition of this server's registry."""
        return self.obs.render()

    # -- the signal layer: profiler and SLOs ---------------------------------

    # (attribute, leg name) of every device leg ``enable_profiler`` watches,
    # the port's names for the JAX package's compiled legs: the dense
    # server's ``_prefill_chunk`` / ``_step_all`` and the paged speculative
    # server's ``_draft_prefill`` keep their names; the paged server's
    # ``_prefill_leg`` / ``_step_leg`` (``forward_chunk_io`` /
    # ``paged_forward_one``) are its ``_prefill_chunk`` / ``_step_all``;
    # the dense speculative server's ``_prefill_slot`` / ``_round`` are its
    # ``_prefill_jit`` / ``_round_jit``. The paged speculative round, built
    # for each gamma (``_round_leg``), is watched per call as
    # ``round[gamma=G]``.
    _PROFILED_LEGS = (("_prefill_chunk", "prefill"), ("_step_all", "step"),
                      ("_prefill_leg", "prefill"), ("_step_leg", "step"),
                      ("_draft_prefill", "draft_prefill"),
                      ("_prefill_slot", "prefill"), ("_round", "round"))

    def enable_profiler(self, sample_every: int = 16) -> ServingProfiler:
        """Turn on the sampled profiler (``obs.profile``): every
        *sample_every*-th ``step()`` records a per-phase wall breakdown
        (schedule / dispatch / device / materialize; the device phase
        waits on that step's own host copy event, the one cost of a
        sampled step), and the device legs (``_PROFILED_LEGS``) are
        wrapped for first-call tracking (``kubetpu_jit_recompiles_total
        {leg=...}`` and its seconds). Enable BEFORE ``warmup()`` to see
        the warmup's first calls attributed per leg. Un-sampled steps
        (and the default, disabled state) add no sync and no upload."""
        prof = ServingProfiler(sample_every=sample_every, registry=self.obs)
        self._profiler = prof
        for attr, leg in self._PROFILED_LEGS:
            fn = getattr(self, attr, None)
            if fn is not None:
                setattr(self, attr, prof.watch(leg, fn))
        return prof

    def profile_summary(self) -> dict:
        """The profiler's structured snapshot (phase breakdown, coverage,
        per-leg first calls) — {} while disabled."""
        return self._profiler.summary() if self._profiler else {}

    def declare_slos(self, objectives: List[Objective],
                     eval_interval: float = 1.0, **engine_kw) -> SloEngine:
        """Attach an SLO engine (``obs.slo``) over this server's own
        registry — ``obs.slo.serving_slos(...)`` builds the standard
        objective set. The engine re-evaluates at most once per
        *eval_interval* seconds, from inside ``step()``; results render as
        ``kubetpu_slo_*`` gauges on ``metrics_text()`` and read through
        ``self.slo.results()`` (the replica's ``GET /slo``)."""
        self.slo = SloEngine(objectives, registry=self.obs, **engine_kw)
        self._slo_interval = float(eval_interval)
        return self.slo

    def _begin_profiled_step(self):
        """The profiler's record for this step (None unless sampled), after
        the SLO engine's throttled evaluation."""
        prof = self._profiler
        rec = prof.begin_step() if prof is not None else None
        if self.slo is not None:
            self.slo.maybe_evaluate(self._slo_interval)
        return rec

    def step(self) -> Dict[int, List[int]]:
        """Admit and advance prefills (under the token budget when set),
        then one decode step for every active slot -> {rid: tokens emitted
        this step}. A request admitted this step emits two tokens: its
        prefill's first and this step's decode. With ``overlap`` this call
        dispatches step N and routes step N-1's tokens."""
        rec = self._begin_profiled_step()
        self._schedule_prefills()
        if rec is not None:
            rec.mark("schedule")
        handle = None
        t0 = time.perf_counter()
        if self.active.any():
            handle = self._dispatch_step()
        if rec is not None:
            rec.mark("dispatch")
            if handle is not None:
                # the one cost of a sampled step: wait for THIS step's host
                # copy (its own event, not the whole device), so the
                # device's time is attributable; the overlap pipeline
                # pauses for this step only
                _wait_staged(handle[0])
                rec.mark("device")
        if self.overlap:
            handle, self._inflight = self._inflight, handle
        out = self._materialize_pending()
        if handle is not None:
            self._route_step(handle, out)
        if rec is not None:
            rec.mark("materialize")
        if handle is not None or self._inflight is not None:
            self._metrics.record("step", time.perf_counter() - t0)
        if rec is not None:
            self._profiler.end_step(rec)
        return out

    def _dispatch_step(self):
        """Queue one decode step and the copy of its tokens and logprobs to
        the host (float64 holds both exactly), without a host sync, and
        capture the (active, rid) snapshot routing needs: under ``overlap``
        the live tables may have moved on (retirement, re-admission) by the
        time the tokens reach the host, and a stale token must never reach
        a new occupant."""
        tokens, lps = self._device_step()
        staged = _stage_to_host(torch.stack([tokens.double(), lps.double()]))
        return staged, self.active.copy(), list(self._slot_rid)

    def _route_step(self, handle, out: Dict[int, List[int]]) -> None:
        """Wait for a dispatched step's host copy (the step's one sync: on
        the card it waits for that step's copy, not for a step dispatched
        after it) and route the tokens by the dispatch-time snapshot; a
        token whose request has since retired or lost the slot is
        discarded."""
        staged, snap_active, snap_rids = handle
        host = _host_values(staged)
        tokens, lps = host[0].astype(np.int64), host[1]
        for slot in range(self.n_slots):
            if not snap_active[slot]:
                continue
            rid = snap_rids[slot]
            if (rid is None or self._done.get(rid, True)
                    or self._slot_rid[slot] != rid):
                continue
            tok = int(tokens[slot])
            self._emitted[rid].append(tok)
            self._logprobs[rid].append(float(lps[slot]))
            self._note_emitted(slot)
            out.setdefault(rid, []).append(tok)
            self._obs_tokens(rid, 1)
            self._retire_if_done(slot)

    def _warmup_buckets(self, prefill_dummy) -> None:
        """Call *prefill_dummy(padded_prompt)* for every power-of-two prompt
        bucket from ``_min_bucket`` to ``max_seq``, padded as a served final
        chunk is. Only valid while no request is in the server: the dummy
        prefill scribbles on slot 0's state."""
        assert (not self.active.any() and not self._queue
                and not self._prefills and self._inflight is None), (
            "warmup() must run before serving: it scribbles on slot 0's "
            "device state (and, for the paged server, on pool pages a "
            "mid-prefill slot may have mapped)")
        bucket = self._min_bucket
        while True:
            dummy = [0] * min(bucket, self.max_seq)
            prefill_dummy(
                dummy + [0] * (self._chunk_bucket(0, len(dummy), True)
                               - len(dummy)))
            if bucket >= self.max_seq:
                break
            bucket *= 2

    def _drain_queue_into_slots(self) -> None:
        """Monolithic admission of queued requests into free slots, first
        token deferred."""
        self._expire_queue()
        while self._queue:
            free = self._free_slots()
            if not free:
                break
            rid, prompt, _deadline = self._queue[0]
            if not self._try_admit(rid, prompt, free[0], defer=True):
                break              # resources exhausted: retry next step
            self._queue.pop(0)

    # -- token-budget chunked prefill ----------------------------------------

    def _chunk_quantum(self) -> int:
        """Smallest chunk granularity (the page size for paged caches)."""
        return 1

    def _chunk_bucket(self, pos: int, take: int, final: bool) -> int:
        """Padded chunk length: final chunks bucket-pad, grid-exact when the
        pad would run past the cache end."""
        bucket = self._bucket(take) if final else take
        if pos + bucket > self.max_seq:
            bucket = take
        return bucket

    def _chunk_take(self, budget: int, pos: int, remaining: int) -> int:
        """Largest bucket-grid chunk (quantum * 2^k) within
        min(max(budget, quantum), remaining); a tail that fits this step's
        allowance finishes now as one bucket-padded final chunk."""
        q = self._chunk_quantum()
        cap = min(max(budget, q), remaining)
        take = q
        while take * 2 <= cap:
            take *= 2
        if (take < remaining and remaining <= max(budget, q)
                and pos + self._bucket(remaining) <= self.max_seq):
            return remaining
        return min(take, remaining)

    def _schedule_prefills(self) -> None:
        """Spend up to ``prefill_budget`` prompt tokens this step: resume
        in-flight chunked prefills (FIFO), then start queued requests in
        free slots. ``prefill_budget == 0`` is the monolithic path."""
        self._expire_queue()
        if self.prefill_budget <= 0:
            self._drain_queue_into_slots()
            return
        budget = self.prefill_budget
        progressed = False
        for slot in list(self._prefill_fifo):
            if budget <= 0:
                return
            used = self._advance_prefill(slot, budget)
            budget -= used
            progressed = progressed or used > 0
        while budget > 0 and self._queue:
            free = self._free_slots()
            if not free:
                break
            rid, prompt, deadline = self._queue.pop(0)
            self._begin_prefill(rid, prompt, free[0], deadline)
            used = self._advance_prefill(free[0], budget)
            budget -= used
            progressed = progressed or used > 0
        # deadlock safeguard (pool pressure): half-prefilled slots can hold
        # pages while none can take its next chunk and no decoder is left to
        # free any — park all but the oldest back at the queue head, pages
        # released, so the oldest owns the freed pool and completes
        if (not progressed and len(self._prefills) > 1
                and not self.active.any()):
            for slot in list(self._prefill_fifo[1:])[::-1]:
                st = self._prefills[slot]
                # parked with its original deadline: parking must not grant
                # a TTL'd request immortality
                self._queue.insert(0, (st["rid"], st["prompt"],
                                       st["deadline"]))
                self._abort_prefill(slot)

    def _begin_prefill(self, rid: int, prompt: List[int], slot: int,
                       deadline: Optional[float] = None) -> None:
        """Occupy *slot* with a chunked prefill; resources are claimed chunk
        by chunk in ``_advance_prefill``. Progress starts at
        ``_prefill_start`` (0 unless the subclass holds the prefix's KV);
        *deadline* is kept only so deadlock parking re-queues the request
        with its clock."""
        self._bind_slot(rid, slot)
        self._record_queue_wait(rid, time.perf_counter())
        self._slot_rid[slot] = rid
        self._done[rid] = False
        self._prefills[slot] = {
            "rid": rid, "prompt": list(prompt),
            "done": self._prefill_start(prompt, slot), "t": 0.0,
            "deadline": deadline}
        self._prefill_fifo.append(slot)

    def _abort_prefill(self, slot: int) -> None:
        """Release a mid-prefill slot (deadlock parking): resources back via
        ``_on_retire``, no result bookkeeping touched."""
        self._prefills.pop(slot, None)
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        self._slot_rid[slot] = None
        self._on_retire(slot)

    def _advance_prefill(self, slot: int, budget: int) -> int:
        """Run one chunk of *slot*'s prefill -> tokens consumed (0 when
        resources are unavailable). The final chunk flips the slot to
        decoding with its first token deferred."""
        st = self._prefills[slot]
        remaining = len(st["prompt"]) - st["done"]
        take = self._chunk_take(budget, st["done"], remaining)
        final = take >= remaining
        t0 = time.perf_counter()
        res = self._prefill_chunk_device(st["prompt"], slot, st["done"],
                                         take, final)
        if res is None:
            return 0
        dt = time.perf_counter() - t0
        st["t"] += dt
        st["done"] += take
        self._metrics.record("prefill_chunk", dt)
        if final:
            self._activate(st["rid"], slot, st["prompt"], res)
            self._pending_first[slot] = self._stage_first(res)
            self._metrics.record("admission_stall", st["t"])
            self._prefills.pop(slot)
            self._prefill_fifo.remove(slot)
            self.events.emit("admit", rid=st["rid"], slot=slot,
                             prompt_tokens=len(st["prompt"]), path="chunked")
        return take

    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        raise NotImplementedError

    def _admit_device(self, prompt: List[int], slot: int):
        raise NotImplementedError

    def _device_step(self):
        raise NotImplementedError

    def _stage_first(self, first) -> tuple:
        """A deferred first token and its logprob (device scalars), staged
        to the host right after its prefill: the fetch then waits for that
        prefill only, not for the step dispatched after it."""
        return _stage_to_host(torch.stack([x.double().reshape(())
                                           for x in first]))

    def _materialize_pending(self) -> Dict[int, List[int]]:
        """Fetch deferred first tokens after the step's decode was queued,
        and run their retire checks."""
        out: Dict[int, List[int]] = {}
        items = sorted(self._pending_first.items())
        self._pending_first.clear()
        for slot, staged in items:
            first, lp = _host_values(staged)
            rid = self._slot_rid[slot]
            if rid is None:
                continue
            tok = int(first)
            self._emitted[rid] = [tok] + self._emitted[rid]
            self._logprobs[rid] = [float(lp)] + self._logprobs[rid]
            out.setdefault(rid, []).append(tok)
            self._obs_tokens(rid, 1)
            self._retire_if_done(slot)
        return out

    def _retire_if_done(self, slot: int) -> None:
        rid = self._slot_rid[slot]
        emitted = self._emitted[rid]
        if len(emitted) >= self.max_new_tokens or (
                self.eos_id is not None and emitted[-1] == self.eos_id):
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        rid = self._slot_rid[slot]
        self.events.emit("retire", rid=rid, slot=slot,
                         emitted=len(self._emitted.get(rid, ())))
        self._done[rid] = True
        self.active[slot] = False           # slot immediately reusable
        self._frozen.discard(slot)          # a migrated-away stream
        self._slot_rid[slot] = None
        self._prefills.pop(slot, None)      # cancel() mid-prefill
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        self._on_retire(slot)

    def cancel(self, rid: int) -> bool:
        """Stop a request wherever it is (queued, mid-prefill or decoding).
        Tokens emitted so far stay readable via ``result`` until
        ``pop_result``. False for unknown or finished ids."""
        if self._done.get(rid, False) or rid not in self._prompts:
            return False
        for i, (qrid, _p, _d) in enumerate(self._queue):
            if qrid == rid:
                self._queue.pop(i)
                self._done[rid] = True
                self._drop_request_state(rid)
                self.events.emit("cancel", rid=rid, queued=True)
                return True
        for slot in range(self.n_slots):
            if self._slot_rid[slot] == rid:
                if slot in self._frozen:
                    # mid-handoff: the target could commit a live copy
                    # after a local retire; the handoff always resolves
                    # (commit-ack retires, refusal unfreezes), cancel after
                    return False
                # a deferred first token must not reach the next occupant
                self._pending_first.pop(slot, None)
                self.events.emit("cancel", rid=rid, queued=False)
                self._retire(slot)
                self._drop_request_state(rid)
                return True
        return False

    # hooks ------------------------------------------------------------------

    def _prefill_start(self, prompt: List[int], slot: int) -> int:
        """Position prefill starts at for a fresh admission into *slot*: 0
        unless a subclass already holds the prefix's KV (the paged server's
        prefix cache maps shared pages and returns the matched, page-aligned
        token count). Called once per admission attempt, after
        ``_bind_slot``, before any device leg; whatever it maps is released
        in ``_on_retire``."""
        return 0

    def _note_admitted(self, slot: int, prompt: List[int]) -> None:
        pass

    def _note_emitted(self, slot: int) -> None:
        pass

    def _on_retire(self, slot: int) -> None:
        pass

    def load_info(self) -> dict:
        """The cheap load snapshot a router polls: host occupancy counters
        and recent-window latency percentiles (no device sync, no render).
        Frozen (mid-migration) slots count as occupied: their handoff has
        not resolved, so a drained-gate must not read the replica idle."""
        return {
            "n_slots": self.n_slots,
            "active_slots": int(self.active.sum()) + len(self._frozen),
            "migrating_slots": len(self._frozen),
            "queue_depth": len(self._queue),
            "inflight_prefills": len(self._prefills),
            "queue_wait_p99_ms": self._metrics.recent_percentile(
                "queue_wait", 99) * 1e3,
            "ttft_p50_ms": self._metrics.recent_percentile(
                "ttft", 50) * 1e3,
            "itl_p99_ms": self._metrics.recent_percentile(
                "itl", 99) * 1e3,
        }

    def tier_stats(self) -> dict:
        """Tiered-KV-cache stats: the base loop has no cache tiers; the
        paged server reports its per-tier counters."""
        return {"enabled": False}

    # -- live migration ------------------------------------------------------
    #
    # The host half of live KV migration: which streams may move, the
    # pause/resume around a wire handoff, and how a migrated-away stream
    # finishes locally. The page half (snapshot_slot / restore_slot) lives
    # on the paged server. All of these are barrier legs: never called from
    # inside step(); they may sync and upload. Under ``overlap`` an unrouted
    # step in flight may still move a stream: the legs refuse until drain()
    # or an idle step flushes it.

    def migratable_rids(self) -> List[int]:
        """Request ids whose stream may be snapshot now: decoding, not
        mid-(chunked-)prefill, first token materialized, not already frozen
        for another handoff. A half-written prefill chunk has no
        token-exact resume point, and an unrouted overlap step may still
        move any stream: none is migratable then."""
        if self._inflight is not None:
            return []
        out: List[int] = []
        for slot in range(self.n_slots):
            rid = self._slot_rid[slot]
            if (rid is None or not self.active[slot]
                    or slot in self._prefills
                    or slot in self._pending_first
                    or slot in self._frozen):
                continue
            out.append(rid)
        return out

    def prefill_progress(self, rid: int) -> Optional[Tuple[int, int]]:
        """(prompt tokens prefilled so far, prompt length) for a request
        mid-chunked-prefill, None otherwise (queued, active, finished).
        Chunk starts are quantum-aligned (the paged server's page size), so
        every full page below the mark is final: the disaggregated
        handoff ships those spans while later chunks still compute."""
        for st in self._prefills.values():
            if st["rid"] == rid:
                return int(st["done"]), len(st["prompt"])
        return None

    def freeze_slot(self, rid: int) -> None:
        """Pause *rid*'s slot for a handoff: inactive for the step legs
        (decode neither advances nor writes it) but not reusable and not
        idle. A frozen stream resumes exactly where it stopped
        (``unfreeze_slot``) or finishes by migrating (``finish_migrated``),
        never both. Refused (ValueError) while an overlap step is in
        flight."""
        if self._inflight is not None:
            raise ValueError("freeze requires the overlap pipeline flushed "
                             "— an unrouted step may still move this "
                             "stream")
        slot = self._slot_rid.index(rid)
        self._frozen.add(slot)
        self.active[slot] = False

    def unfreeze_slot(self, rid: int) -> None:
        """Resume a frozen stream after a definitively refused handoff: it
        continues here token-exactly (its device state never moved).
        Tolerates a stream canceled mid-transfer."""
        try:
            slot = self._slot_rid.index(rid)
        except ValueError:
            return                 # canceled while the wire leg ran
        if slot in self._frozen:
            self._frozen.discard(slot)
            self.active[slot] = True

    def finish_migrated(self, rid: int, info: dict) -> None:
        """Source-side completion of a migrated stream: the slot frees like
        a retire (pages released, prefix published), but the request
        finishes as migrated: result readers get the new owner (*info*:
        replica/rid/epoch, via ``migrated_to``) instead of tokens. Only
        after the target's commit-ack, or on an ambiguous outcome, where
        resuming could double-run the stream."""
        if rid in self._prompts:   # a canceled-and-popped rid must not
            self._migrated[rid] = dict(info)   # leak an unpoppable entry
        try:
            slot = self._slot_rid.index(rid)
        except ValueError:
            return                 # canceled while the wire leg ran
        self.events.emit("migrate_out", rid=rid, slot=slot,
                         replica=info.get("replica"),
                         epoch=info.get("epoch"))
        self._retire(slot)

    def migrated_to(self, rid: int) -> Optional[dict]:
        """Where a migrated-away stream went ({replica, rid, epoch,
        ambiguous?}), or None for streams that finished here."""
        return self._migrated.get(rid)

    def cancel_expired(self, rid: int, reason: str) -> bool:
        """Cancel *rid* and mark it expired with *reason*, so the wire
        layer answers a retryable 503 (like a queue-TTL expiry) instead of
        partial tokens: the drain-timeout escalation."""
        if self._done.get(rid, False):
            return False
        self._expired[rid] = str(reason)
        ok = self.cancel(rid)
        if not ok:
            self._expired.pop(rid, None)
        return ok

    def unfinished_rids(self) -> List[int]:
        """Every request not yet finished — queued, mid-prefill, active or
        frozen — the set a drain timeout must resolve."""
        out: List[int] = [rid for rid, _p, _d in self._queue]
        out += [st["rid"] for st in self._prefills.values()]
        out += [r for r in self._slot_rid if r is not None]
        seen: set = set()
        uniq = []
        for r in out:
            if r not in seen and not self._done.get(r, False):
                seen.add(r)
                uniq.append(r)
        return uniq

    def snapshot_slot(self, rid: int, from_page: int = 0,
                      allow_frozen: bool = False) -> dict:
        """The base server carries no shippable cache view: migration is
        the paged server's (the page table is the portable form). Raises
        NotImplementedError, which the wire layer's migrate and handoff
        legs treat as a per-stream skip; the signature is the paged one,
        so a keyword call cannot raise TypeError past those handlers."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support live migration — "
            f"snapshot/restore ship the paged servers' page view")

    def restore_slot(self, snap: dict, reason: str = "migrate"):
        raise NotImplementedError(
            f"{type(self).__name__} does not support live migration — "
            f"snapshot/restore ship the paged servers' page view")

    def _snapshot_request(self, rid: int, slot: int) -> dict:
        """The cache-layout-free half of a slot snapshot: request
        bookkeeping (prompt, emitted, logprobs, sampling), the raw request
        key (restore reuses it verbatim, so seeded sampling continues
        exactly), position and last token, and the stream's handoff
        identity. The port's 63-bit request key ships as [hi32, lo32], the
        two words the JAX package's key fills. Reading ``last`` is the
        snapshot's designed device sync."""
        key = int(self._slot_reqkey[slot])
        return {
            "version": 1,
            "prompt": [int(t) for t in self._prompts[rid]],
            "emitted": [int(t) for t in self._emitted[rid]],
            "logprobs": [float(x) for x in self._logprobs[rid]],
            "sampling": list(self._rid_sampling.get(
                rid, self._default_sampling)),
            "reqkey": [key >> 32, key & 0xFFFFFFFF],
            "pos": int(self.pos[slot]),
            "last": int(self.last[slot]),
            "origin": (list(self._stream_origin[rid])
                       if rid in self._stream_origin else None),
            "epoch": int(self._stream_epoch.get(rid, 0)),
            "max_new_tokens": self.max_new_tokens,
            "eos_id": self.eos_id,
        }

    def _restore_request(self, snap: dict, slot: int) -> int:
        """Rebuild the request-state half of a restored slot -> the new
        local rid. The caller (``restore_slot``) owns the pages and the
        activation order; this leg installs bookkeeping and the slot's
        sampling state."""
        prompt = [int(t) for t in snap["prompt"]]
        emitted = [int(t) for t in snap["emitted"]]
        rid = self._next_rid
        self._next_rid += 1
        s = snap.get("sampling") or list(self._default_sampling)
        self._rid_sampling[rid] = (float(s[0]), int(s[1]), float(s[2]))
        now = time.perf_counter()
        self._arrive[rid] = now        # TTFT/ITL restart at the handoff:
        self._last_emit[rid] = now     # the blip is the honest number
        self._qw_recorded.add(rid)     # queue wait was paid at the source
        self._bind_slot(rid, slot)
        # the source's request key, verbatim: a sampled continuation draws
        # exactly what an unmigrated run would have drawn
        hi, lo = (int(w) for w in snap["reqkey"])
        self._slot_reqkey[slot] = (hi << 32) | lo
        self._prompts[rid] = prompt
        self._emitted[rid] = emitted
        self._logprobs[rid] = [float(x) for x in snap.get("logprobs", [])]
        self._done[rid] = False
        self._slot_rid[slot] = rid
        self._stream_epoch[rid] = int(snap.get("epoch", 0))
        if snap.get("origin") is not None:
            self._stream_origin[rid] = tuple(snap["origin"])
        return rid

    # -- meshed serving -------------------------------------------------------

    def _host_state(self) -> list:
        """The host scheduler's state every rank of a meshed server must
        hold alike (the paged server adds its table and free list)."""
        return [self.pos.tolist(), self.active.tolist(), self._slot_rid,
                [q[0] for q in self._queue], sorted(self._prefills),
                self._next_rid, sorted(self._done.items())]

    def check_lockstep(self) -> None:
        """On a mesh: every rank's host state (``_host_state``) equal to
        rank 0's, compared by a digest gathered over the whole mesh (four
        16-bit words as f32, exact); AssertionError naming the ranks that
        differ. A no-op without a mesh."""
        if self.mesh is None:
            return
        digest = hashlib.sha256(repr(self._host_state()).encode()).digest()
        words = [int.from_bytes(digest[i:i + 2], "little")
                 for i in range(0, 8, 2)]
        mine = torch.tensor(words, dtype=torch.float32, device=self.device)
        every = col.all_gather(
            mine[None], self._groups.over(*self.mesh.mesh_dim_names),
            "lockstep").cpu()
        off = [r for r in range(every.shape[0])
               if not torch.equal(every[r], every[0])]
        assert not off, f"ranks {off} hold host state unlike rank 0's"

    # -- results -------------------------------------------------------------

    def finished(self, rid: int) -> bool:
        return self._done.get(rid, False)

    def result(self, rid: int) -> List[int]:
        """prompt + emitted tokens (final once finished); kept until
        ``pop_result``."""
        return self._prompts[rid] + self._emitted[rid]

    def result_logprobs(self, rid: int) -> List[float]:
        """Raw-distribution log-probability of each emitted token."""
        return list(self._logprobs[rid])

    def pop_result(self, rid: int) -> List[int]:
        """Collect and evict a finished request's tokens."""
        if not self._done.get(rid, False):
            raise KeyError(f"request {rid} is not finished")
        out = self._prompts.pop(rid) + self._emitted.pop(rid)
        del self._done[rid]
        self._drop_request_state(rid)
        self._logprobs.pop(rid, None)
        self._expired.pop(rid, None)
        self._arrive.pop(rid, None)
        self._last_emit.pop(rid, None)
        self._qw_recorded.discard(rid)
        self._migrated.pop(rid, None)
        self._stream_epoch.pop(rid, None)
        self._stream_origin.pop(rid, None)
        return out

    def _runnable(self) -> bool:
        """A ``step()`` would advance something: active decodes, queued
        admissions, in-flight prefill chunks or an unrouted overlap step.
        A server whose only work is frozen (mid-migration) slots is not
        runnable, and not idle either."""
        return bool(self.active.any() or self._queue or self._prefills
                    or self._inflight is not None)

    def _idle(self) -> bool:
        """Nothing to do, no unrouted overlap step and no stream frozen
        mid-migration (its handoff has not resolved yet)."""
        return not self._runnable() and not self._frozen

    def drain(self, max_steps: int = 10_000) -> None:
        """Run until every admitted and queued request finishes (flushing
        the in-flight prefill chunks and the overlap pipeline)."""
        for _ in range(max_steps):
            if self._idle():
                return
            self.step()
        raise RuntimeError("drain did not converge")


def _serving_groups(cfg: ModelConfig, mesh) -> col.MeshGroups:
    """*mesh*'s groups for a server: its axes are dp, tp and (for experts)
    ep; sp and pp are training axes."""
    from kubetpu_torch.jobs.train import check_mesh

    check_mesh(cfg, mesh)
    for axis in ("sp", "dcn"):
        if col.axis_size(mesh, axis) > 1:
            raise ValueError(f"a server's mesh takes dp, tp and ep, not "
                             f"{axis}")
    return col.groups_of(mesh)


def _build_dense_legs(cfg: ModelConfig, cache_io, lora_scale: float = 1.0):
    """(prefill_chunk, step_all) for the contiguous-cache server; the server
    samples from the logits they return. The trailing (lora, aid / aids)
    pair is the multi-LoRA hook: (None, None) for the plain server.

    ``prefill_chunk(params, cache, chunk (1, T), slot, pos, lora, aid) ->
    logits (1, T, V)``: one slot's chunk at *pos* through views of its
    cache rows, written in place.

    ``step_all(params, cache, last, pos, active, lora, aids) -> logits
    (B, V)``: one token for every slot at its own position. An inactive
    slot writes at row S_max - 1 instead of its stale position (a
    mid-prefill neighbour's chunks live there): that row is never read
    before the step that rewrites it."""

    @torch.no_grad()
    def prefill_chunk(params, cache, chunk, slot: int, pos: int, lora=None,
                      aid=None):
        cache_s = _rows(cache, slice(slot, slot + 1))
        return forward_chunk_io(cfg, params, chunk, cache_s, pos, cache_io,
                                lora, aid, lora_scale)[0]

    @torch.no_grad()
    def step_all(params, cache, last, pos, active, lora=None, aids=None):
        leaf = cache[0][0] if isinstance(cache[0], tuple) else cache[0]
        pos_w = torch.where(active, pos, leaf.shape[2] - 1)
        logits, _ = forward_chunk_at_io(cfg, params, last[:, None], cache,
                                        pos_w, cache_io, lora, aids,
                                        lora_scale)
        return logits[:, 0]

    return prefill_chunk, step_all


class DecodeServer(SlotServerBase):
    """Continuous batching over one model with a contiguous per-slot KV
    cache (port of the JAX package's ``DecodeServer``): dense in
    ``cfg.dtype``, or int8 with per-token, per-head scales
    (``kv_int8=True``). The legs are cache-layout-blind (a cache tree and a
    ``cache_io`` strategy); ``PagedDecodeServer`` is the pool-backed
    sibling.

    ``prefill_budget=N`` streams queued prompts in as chunks of at most ~N
    tokens a step, token-exact against monolithic admission;
    ``overlap=True`` double-buffers the host loop (``SlotServerBase``).
    Live migration is the paged servers': ``snapshot_slot`` and
    ``restore_slot`` raise ``NotImplementedError``, which the wire layer
    treats as a per-stream skip. The attention is plain PyTorch (the JAX
    package's dense path has no Pallas kernel); ``device`` defaults to the
    card and raises without CUDA.

    ``mesh=``: the parameters are cut by ``train.param_specs``, the cache
    holds the rank's ``H_kv/tp`` heads, and when dp divides ``n_slots``
    the rank's ``n_slots/dp`` slots (slot s on dp rank ``s // (n_slots /
    dp)``), else every slot (replicated over dp). With slots on dp a rank
    runs its own slots' prefill chunks and step rows; the first token of a
    prefill is broadcast from its owner, and each step's tokens and
    logprobs are gathered over dp, before routing."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 n_slots: int = 8, max_seq: int = 512,
                 max_new_tokens: int = 64, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 kv_int8: bool = False, prefill_budget: int = 0,
                 overlap: bool = False, queue_ttl: Optional[float] = None,
                 device=None, mesh=None) -> None:
        device = resolve_device(device)
        for p in params.state_dict().values():   # int8 buffers too
            if p.device.type != device.type:
                raise ValueError(f"params live on {p.device}, the server "
                                 f"on {device}")
        super().__init__(cfg, params, n_slots, max_seq, max_new_tokens,
                         eos_id, temperature=temperature, top_k=top_k,
                         top_p=top_p, seed=seed,
                         prefill_budget=prefill_budget, overlap=overlap,
                         queue_ttl=queue_ttl, device=device, mesh=mesh)
        self.kv_int8 = bool(kv_int8)
        # this rank's slots [lo, hi): its dp block when dp divides n_slots
        dp = col.axis_size(mesh, "dp")
        self._dp_group = None
        self._lo, self._hi = 0, n_slots
        if dp > 1 and n_slots % dp == 0:
            self._dp_group = self._groups.over("dp")
            n_local = n_slots // dp
            self._lo = col.axis_index(mesh, "dp") * n_local
            self._hi = self._lo + n_local
        tp = col.axis_size(mesh, "tp")
        rows = self._hi - self._lo
        if kv_int8:
            self.cache = init_kv_cache_int8(cfg, rows, max_seq, device, tp)
            cache_io = _int8_cache_io(cfg.window)
        else:
            self.cache = init_kv_cache(cfg, rows, max_seq, device, tp)
            cache_io = _dense_cache_io(cfg.window)
        self._prefill_chunk, self._step_all = _build_dense_legs(
            cfg, cache_io, self._lora_scale)
        self._sampler = make_slot_sampler()

    @property
    def k_cache(self) -> torch.Tensor:
        """The dense layout's K cache; an int8 server has none (read
        ``cache``, the ((kq, ks), (vq, vs)) tree)."""
        if self.kv_int8:
            raise AttributeError(
                "kv_int8 server: no dense k_cache tensor — use self.cache")
        return self.cache[0]

    @property
    def v_cache(self) -> torch.Tensor:
        if self.kv_int8:
            raise AttributeError(
                "kv_int8 server: no dense v_cache tensor — use self.cache")
        return self.cache[1]

    # -- device legs ---------------------------------------------------------

    def _admit_device(self, prompt: List[int], slot: int):
        """The whole-prompt prefill as one pos-0 final chunk; the first
        token stays a device scalar."""
        return self._prefill_chunk_device(prompt, slot, 0, len(prompt), True)

    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        """One prefill chunk through the slot's cache rows: non-final
        chunks are exact bucket-grid sizes, final chunks bucket-pad (pad
        positions are rewritten before any read). The first token and its
        logprob (device scalars) for the final chunk, True otherwise; the
        draw at position q is seeded from (request, q - 1). With slots on
        dp only the slot's owner runs the chunk, and the first token
        reaches every rank by a broadcast over dp."""
        owner = self._lo <= slot < self._hi
        first = None
        if owner:
            bucket = self._chunk_bucket(pos, take, final)
            chunk = prompt[pos:pos + take] + [0] * (bucket - take)
            logits = self._prefill_chunk(
                self.params, self.cache,
                self._upload(np.asarray([chunk], np.int64)),
                slot - self._lo, pos, *self._admit_lora(slot))
            if final:
                r = logits[0, take - 1]
                temp, tk, tp = self._slot_sampling(slot)
                tok = self._sampler(
                    r, temp, tk, tp,
                    row_seed(self._slot_reqkey[slot], pos + take - 1))
                first = tok, chosen_logprob(r, tok)
        if not final:
            return True
        if self._dp_group is None:
            return first
        # (token, logprob) as f32, exact: the dtypes gloo takes on CUDA
        pair = (torch.stack([first[0].float(), first[1].float()]) if owner
                else torch.zeros(2, dtype=torch.float32, device=self.device))
        src = torch.distributed.get_global_rank(
            self._dp_group, slot // (self._hi - self._lo))
        col.broadcast_(pair, src, self._dp_group, "dp_tokens")
        return pair[0].long(), pair[1]

    def _device_step(self):
        lo, hi = self._lo, self._hi
        active = self._upload(self.active[lo:hi])
        lora, aids = self._step_lora()
        last = self.last[lo:hi]
        logits = self._step_all(self.params, self.cache, last,
                                self._upload(self.pos[lo:hi].astype(
                                    np.int32)),
                                active, lora,
                                None if aids is None else aids[lo:hi])
        seeds = None                       # all-greedy: no draw needs one
        if (self._slot_temp[lo:hi] > 0).any():
            seeds = [row_seed(self._slot_reqkey[s], int(self.pos[s]))
                     for s in range(lo, hi)]
        nxt = self._sampler(logits, self._slot_temp[lo:hi],
                            self._slot_topk[lo:hi], self._slot_topp[lo:hi],
                            seeds)
        nxt = torch.where(active, nxt, last)   # inactive slots hold
        lp = chosen_logprob(logits, nxt)
        if self._dp_group is not None:
            # every slot's (token, logprob) on every rank, as f32 (exact)
            both = col.all_gather(torch.stack([nxt.float(), lp.float()]),
                                  self._dp_group, "dp_tokens", dim=1)
            nxt, lp = both[0].long(), both[1]
        self.pos += self.active
        self.last = nxt
        return nxt, lp

    @torch.no_grad()
    def warmup(self) -> None:
        """Run a dummy prefill for every prompt bucket and one masked step,
        so the allocator holds its blocks and every library handle exists
        before the first request. Only valid on an idle server: the dummy
        prefill rewrites slot 0's cache rows."""
        lo, hi = self._lo, self._hi
        self._warmup_buckets(lambda padded: self._prefill_chunk(
            self.params, self.cache,
            self._upload(np.zeros((1, len(padded)), np.int64)), 0, 0,
            *self._admit_lora(lo)))
        lora, aids = self._step_lora()
        self._step_all(self.params, self.cache, self.last[lo:hi],
                       self._upload(np.zeros((hi - lo,), np.int32)),
                       self._upload(np.zeros((hi - lo,), bool)), lora,
                       None if aids is None else aids[lo:hi])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
