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

Not ported yet (later slices): ``overlap``, ``queue_ttl``, the obs registry
and latency metrics, the SLO engine, the profiler, warmup, and
freeze/migration.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubetpu_torch.jobs.model import (ModelConfig, Transformer,
                                      resolve_device)
from kubetpu_torch.jobs.sampling import row_seed


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
      one decode step for all slots;
    - optional hook ``_on_retire(slot)``: release the slot's resources.
    """

    _min_bucket = 1

    def __init__(self, cfg: ModelConfig, params: Transformer, n_slots: int,
                 max_seq: int, max_new_tokens: int, eos_id: Optional[int],
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 prefill_budget: int = 0, device=None) -> None:
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
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
        # token-budget scheduler state: slot -> in-flight prefill progress
        self._prefills: Dict[int, dict] = {}
        self._prefill_fifo: List[int] = []
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
        self._queue: List[Tuple[int, List[int]]] = []
        self._pending_first: Dict[int, tuple] = {}     # slot -> device scalars

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host array *a* on the server's device, without waiting
        for the device's queue (the host copy is private to the transfer)."""
        return torch.from_numpy(np.array(a, copy=True)).to(
            self.device, non_blocking=True)

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

    def _free_slots(self) -> List[int]:
        """Slots holding neither an active decode nor an in-flight prefill."""
        return [i for i in range(self.n_slots)
                if not self.active[i] and i not in self._prefills]

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

    def _try_admit(self, rid: int, prompt: List[int], slot: int,
                   defer: bool = False) -> bool:
        """Monolithic admission: whole-prompt prefill. With ``defer`` the
        first token stays on the device until the step's routing."""
        self._bind_slot(rid, slot)
        admitted = self._admit_device(prompt, slot)
        if admitted is None:
            return False
        self._activate(rid, slot, prompt, admitted)
        self._prompts[rid] = list(prompt)
        self._done[rid] = False
        if defer:
            self._emitted[rid] = []
            self._logprobs[rid] = []
            self._pending_first[slot] = admitted
        else:
            first, first_lp = admitted
            self._emitted[rid] = [int(first)]
            self._logprobs[rid] = [float(first_lp)]
            self._retire_if_done(slot)
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
        if not self._try_admit(rid, prompt, free[0]):
            del self._rid_sampling[rid]
            return None
        self._next_rid += 1
        return rid

    def enqueue(self, prompt: List[int],
                sampling: Optional[dict] = None) -> int:
        """Non-blocking admission: host bookkeeping only; the request enters
        a slot at a later ``step``. Always returns a request id."""
        self._check_prompt(prompt)
        rid = self._next_rid
        self._next_rid += 1
        self._rid_sampling[rid] = self._normalize_sampling(sampling)
        self._prompts[rid] = list(prompt)
        self._emitted[rid] = []
        self._logprobs[rid] = []
        self._done[rid] = False
        self._queue.append((rid, list(prompt)))
        return rid

    def step(self) -> Dict[int, List[int]]:
        """Admit and advance prefills (under the token budget when set),
        then one decode step for every active slot -> {rid: tokens emitted
        this step}. A request admitted this step emits two tokens: its
        prefill's first and this step's decode."""
        self._schedule_prefills()
        handle = None
        if self.active.any():
            tokens, lps = self._device_step()
            handle = (tokens, lps, self.active.copy(), list(self._slot_rid))
        out = self._materialize_pending()
        if handle is not None:
            self._route_step(handle, out)
        return out

    def _route_step(self, handle, out: Dict[int, List[int]]) -> None:
        """Copy the step's tokens to the host (its one sync) and route them
        by the dispatch-time snapshot; a token whose request has since
        retired is discarded."""
        tokens_d, lps_d, snap_active, snap_rids = handle
        tokens = tokens_d.cpu().numpy()
        lps = lps_d.cpu().numpy()
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
            out.setdefault(rid, []).append(tok)
            self._retire_if_done(slot)

    def _drain_queue_into_slots(self) -> None:
        """Monolithic admission of queued requests into free slots, first
        token deferred."""
        while self._queue:
            free = self._free_slots()
            if not free:
                break
            rid, prompt = self._queue[0]
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
            rid, prompt = self._queue.pop(0)
            self._begin_prefill(rid, prompt, free[0])
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
                self._queue.insert(0, (st["rid"], st["prompt"]))
                self._abort_prefill(slot)

    def _begin_prefill(self, rid: int, prompt: List[int], slot: int) -> None:
        """Occupy *slot* with a chunked prefill; resources are claimed chunk
        by chunk in ``_advance_prefill``."""
        self._bind_slot(rid, slot)
        self._slot_rid[slot] = rid
        self._done[rid] = False
        self._prefills[slot] = {"rid": rid, "prompt": list(prompt),
                                "done": 0}
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
        res = self._prefill_chunk_device(st["prompt"], slot, st["done"],
                                         take, final)
        if res is None:
            return 0
        st["done"] += take
        if final:
            self._activate(st["rid"], slot, st["prompt"], res)
            self._pending_first[slot] = res
            self._prefills.pop(slot)
            self._prefill_fifo.remove(slot)
        return take

    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        raise NotImplementedError

    def _admit_device(self, prompt: List[int], slot: int):
        raise NotImplementedError

    def _device_step(self):
        raise NotImplementedError

    def _materialize_pending(self) -> Dict[int, List[int]]:
        """Fetch deferred first tokens after the step's decode was queued,
        and run their retire checks."""
        out: Dict[int, List[int]] = {}
        for slot, (first, lp) in sorted(self._pending_first.items()):
            rid = self._slot_rid[slot]
            if rid is None:
                continue
            tok = int(first)
            self._emitted[rid] = [tok] + self._emitted[rid]
            self._logprobs[rid] = [float(lp)] + self._logprobs[rid]
            out.setdefault(rid, []).append(tok)
            self._retire_if_done(slot)
        self._pending_first.clear()
        return out

    def _retire_if_done(self, slot: int) -> None:
        rid = self._slot_rid[slot]
        emitted = self._emitted[rid]
        if len(emitted) >= self.max_new_tokens or (
                self.eos_id is not None and emitted[-1] == self.eos_id):
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        rid = self._slot_rid[slot]
        self._done[rid] = True
        self.active[slot] = False           # slot immediately reusable
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
        for i, (qrid, _p) in enumerate(self._queue):
            if qrid == rid:
                self._queue.pop(i)
                self._done[rid] = True
                self._rid_sampling.pop(rid, None)
                return True
        for slot in range(self.n_slots):
            if self._slot_rid[slot] == rid:
                # a deferred first token must not reach the next occupant
                self._pending_first.pop(slot, None)
                self._retire(slot)
                self._rid_sampling.pop(rid, None)
                return True
        return False

    # hooks ------------------------------------------------------------------

    def _on_retire(self, slot: int) -> None:
        pass

    def load_info(self) -> dict:
        """Host-side occupancy counters (no device sync)."""
        return {
            "n_slots": self.n_slots,
            "active_slots": int(self.active.sum()),
            "queue_depth": len(self._queue),
            "inflight_prefills": len(self._prefills),
        }

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
        self._rid_sampling.pop(rid, None)
        self._logprobs.pop(rid, None)
        return out

    def _idle(self) -> bool:
        return not (self.active.any() or self._queue or self._prefills)

    def drain(self, max_steps: int = 10_000) -> None:
        """Run until every admitted and queued request finishes."""
        for _ in range(max_steps):
            if self._idle():
                return
            self.step()
        raise RuntimeError("drain did not converge")
