"""Speculative decoding inside the continuous-batching servers (port of
``kubetpu/jobs/spec_serving.py``).

``SpeculativeDecodeServer`` is ``SlotServerBase``'s request lifecycle over
dense per-slot caches with the decode step replaced by a speculative round:
the draft proposes ``gamma`` tokens per slot, the target verifies them in
one (gamma+1)-token chunk (``speculative.draft_and_verify``), and each slot
emits its longest agreeing prefix plus the target's correction or bonus
token. Per-slot positions diverge as slots accept different counts;
rejected entries need no rollback.

``PagedSpeculativeDecodeServer`` runs the same rounds over
``paged.PagedDecodeServer``'s pool: the verify chunk writes and reads
through the slot's page table (``paged.paged_forward_chunk``, whose
attention is ``ops.paged_attention_chunk``: the hand-written kernel on the
card, its plain version on the CPU), so speculation composes with chunked
prefill, int8 pools and shared-prefix hits (a hit skips the draft's prefill
of the matched tokens too: stale draft KV can only lower acceptance, never
change the output, because verification is greedy-exact). The draft keeps
a dense per-slot cache (``decode.init_kv_cache``), prefilled by the dense
server's legs. Adaptive gamma walks each slot's gamma in [1, gamma_max] on
an EMA of its acceptance; the round runs at the largest gamma of the active
slots and caps each slot's acceptance at its own.

A round is queued without a host sync and read back in one transfer (the
accepted tokens decide what the host emits). Both servers are greedy-only
(sampling overrides are refused) and take no ``overlap``: a round emits a
variable burst. Their output equals their plain siblings' greedy stream.
The registry exports ``kubetpu_spec_rounds_total``,
``kubetpu_spec_accepted_tokens_total``, ``kubetpu_spec_proposed_tokens_total``,
``kubetpu_spec_mean_tokens_per_round`` and (paged) a per-slot
``kubetpu_spec_gamma``, the JAX package's series names.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubetpu_torch.jobs.decode import (_dense_cache_io, _rows, forward_chunk,
                                       init_kv_cache)
from kubetpu_torch.jobs.model import (ModelConfig, Transformer,
                                      reference_config_repr, resolve_device)
from kubetpu_torch.jobs.paged import PagedDecodeServer, paged_forward_chunk
from kubetpu_torch.jobs.sampling import chosen_logprob
from kubetpu_torch.jobs.serving import (SlotServerBase, _build_dense_legs,
                                        _host_values, _stage_to_host,
                                        _wait_staged)
from kubetpu_torch.jobs.speculative import (_accepted, draft_and_verify,
                                            draft_propose)

# adaptive gamma: the per-slot acceptance EMA walks gamma down when fewer
# than half the proposals convert and back up when nearly all do, one step
# a round
_EMA_ALPHA = 0.5
_GAMMA_UP = 0.85
_GAMMA_DOWN = 0.5


class _SpecRoundsMixin:
    """Tokens-per-round bookkeeping of both speculative servers, zeroed by
    ``_init_spec_obs`` and fed by ``_route_round``."""

    def mean_tokens_per_round(self) -> float:
        """Emitted tokens per live (slot, round): the speedup over
        one-token decoding for a memory-bound target."""
        return self._round_tokens / self._rounds if self._rounds else 0.0


def _init_spec_obs(server) -> None:
    """The speculation counters on the server's registry: rounds run,
    draft tokens proposed and accepted, and tokens per round."""
    server._rounds = 0
    server._round_tokens = 0
    server._c_spec_rounds = server.obs.counter(
        "kubetpu_spec_rounds_total", "device draft+verify rounds executed")
    server._c_spec_accepted = server.obs.counter(
        "kubetpu_spec_accepted_tokens_total",
        "draft tokens accepted by the target verifier")
    server._c_spec_proposed = server.obs.counter(
        "kubetpu_spec_proposed_tokens_total",
        "draft tokens proposed for verification")
    server.obs.gauge_fn("kubetpu_spec_mean_tokens_per_round",
                        server.mean_tokens_per_round)


def _route_round(server, toks, n_emit, lps, out):
    """Route one round's host copies (toks, lps (n_slots, gamma+1); n_emit
    (n_slots,)): the acceptance counters at device level, then clipping at
    the room left and at EOS, emission, logprobs and retirement. Hooks:
    ``_slot_proposed(slot)`` and ``_note_round_result``."""
    server._c_spec_rounds.inc()
    for slot in range(server.n_slots):
        if not server.active[slot]:
            continue
        rid = server._slot_rid[slot]
        n_dev = int(n_emit[slot])
        proposed = server._slot_proposed(slot)
        server._c_spec_proposed.inc(proposed)
        server._c_spec_accepted.inc(max(n_dev - 1, 0))
        server._note_round_result(slot, max(n_dev - 1, 0), proposed)
        accepted = [int(t) for t in toks[slot][:n_dev]]
        room = server.max_new_tokens - len(server._emitted[rid])
        accepted = accepted[:room]
        if server.eos_id is not None and server.eos_id in accepted:
            accepted = accepted[:accepted.index(server.eos_id) + 1]
        if not accepted:
            server._retire_if_done(slot)
            continue
        server._rounds += 1
        server._round_tokens += len(accepted)
        server._emitted[rid].extend(accepted)
        server._logprobs[rid].extend(
            float(x) for x in lps[slot][:len(accepted)])
        for _ in accepted:
            server._note_emitted(slot)
        out.setdefault(rid, []).extend(accepted)
        server._obs_tokens(rid, len(accepted))
        server._retire_if_done(slot)
    return out


def _stage_round(target_tok, n_emit, lps):
    """Queue a round's device results' copy to the host as one transfer,
    without waiting -> (staged copy, G). float64 holds the token ids and
    the f32 logprobs exactly."""
    return (_stage_to_host(torch.cat([target_tok.double(),
                                      n_emit.double()[:, None],
                                      lps.double()], dim=1)),
            target_tok.shape[1])


def _round_values(staged, g: int):
    """A staged round as host arrays (the round's one sync): (toks (B, G)
    int64, n_emit (B,) int64, lps (B, G) f64)."""
    host = _host_values(staged)
    return (host[:, :g].astype(np.int64), host[:, g].astype(np.int64),
            host[:, g + 1:])


def _profiled_round(rec, device_round):
    """A round's host copies, with the sampled step's phase marks: the
    round queued (``dispatch``), its own copy event waited on
    (``device``), then read. *device_round* queues the round -> device
    (target_tok, n_emit, lps)."""
    staged, g = _stage_round(*device_round())
    if rec is not None:
        rec.mark("dispatch")
        _wait_staged(staged)
        rec.mark("device")
    return _round_values(staged, g)


def _end_round_step(server, rec, out):
    """Close a sampled step's record (routing is its ``materialize``)."""
    if rec is not None:
        rec.mark("materialize")
        server._profiler.end_step(rec)
    return out


def _refuse_sampling(server, sampling):
    if sampling is not None:
        raise ValueError(f"{type(server).__name__} is greedy-exact; "
                         "per-request sampling is not supported")
    return server._default_sampling


class SpeculativeDecodeServer(_SpecRoundsMixin, SlotServerBase):
    """Continuous batching with draft+verify rounds over dense per-slot
    caches (greedy-exact). ``target_cfg`` and ``draft_cfg`` share a
    vocabulary; the surface is ``DecodeServer``'s (submit, enqueue, step,
    drain, result), except that sampling overrides are refused and a step
    may emit up to ``gamma + 1`` tokens a request. Admission is monolithic.
    ``device`` defaults to the card and raises without CUDA."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 target_params: Transformer, draft_params: Transformer,
                 n_slots: int = 8, max_seq: int = 512,
                 max_new_tokens: int = 64, eos_id: Optional[int] = None,
                 gamma: int = 4, seed: int = 0,
                 queue_ttl: Optional[float] = None, device=None) -> None:
        if target_cfg.vocab != draft_cfg.vocab:
            raise ValueError("target and draft must share a vocabulary")
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        device = resolve_device(device)
        super().__init__(target_cfg, target_params, n_slots, max_seq,
                         max_new_tokens, eos_id, seed=seed,
                         queue_ttl=queue_ttl, device=device)
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.gamma = int(gamma)
        # a round's verify chunk may write up to gamma tokens past a
        # sequence's final accepted position before the host retires it
        cache_len = max_seq + gamma + 1
        self.k_cache, self.v_cache = init_kv_cache(target_cfg, n_slots,
                                                   cache_len, device)
        self.dk_cache, self.dv_cache = init_kv_cache(draft_cfg, n_slots,
                                                     cache_len, device)
        _init_spec_obs(self)

    def _normalize_sampling(self, sampling):
        return _refuse_sampling(self, sampling)

    # -- device legs ---------------------------------------------------------

    @torch.no_grad()
    def _prefill_slot(self, padded: List[int], slot: int, prompt_len: int):
        """Both models prefill the bucket-padded prompt into the slot's rows
        at position 0; the target's last real position picks token 0."""
        chunk = self._upload(np.asarray([padded], np.int64))
        sl = slice(slot, slot + 1)
        t_logits, _, _ = forward_chunk(
            self.cfg, self.params, chunk, *_rows((self.k_cache, self.v_cache),
                                                 sl), 0)
        forward_chunk(self.draft_cfg, self.draft_params, chunk,
                      *_rows((self.dk_cache, self.dv_cache), sl), 0)
        row = t_logits[0, prompt_len - 1]
        first = torch.argmax(row)
        return first, chosen_logprob(row, first)

    def _admit_device(self, prompt: List[int], slot: int):
        padded = prompt + [0] * (self._bucket(len(prompt)) - len(prompt))
        return self._prefill_slot(padded, slot, len(prompt))

    @torch.no_grad()
    def _round(self, active: np.ndarray):
        """One round for every slot, queued without a host sync -> device
        (target_tok (B, gamma+1), n_emit (B,), lps (B, gamma+1))."""
        active_d = self._upload(active)
        pos = self._upload(self.pos)
        (_, _, _, _, target_tok, accepted,
         t_logits) = draft_and_verify(
            self.cfg, self.draft_cfg, self.gamma, self.params,
            self.draft_params, self.k_cache, self.v_cache, self.dk_cache,
            self.dv_cache, self.last, pos)
        n_emit = torch.where(active_d, accepted + 1, 0)
        new_last = torch.gather(target_tok, 1,
                                torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
        self.last = torch.where(active_d, new_last, self.last)
        return target_tok, n_emit, chosen_logprob(t_logits, target_tok)

    def _device_step(self):
        raise NotImplementedError("speculative serving steps in rounds")

    def step(self) -> Dict[int, List[int]]:
        """One speculative round for every active slot -> {rid: [tokens]};
        each request receives 1..gamma+1 tokens (clipped at EOS and
        max_new_tokens on the host; the device overshoot is never read)."""
        rec = self._begin_profiled_step()
        self._drain_queue_into_slots()
        if rec is not None:
            rec.mark("schedule")
        if not self.active.any():
            return _end_round_step(self, rec, self._materialize_pending())
        t0 = time.perf_counter()
        toks, n_emit, lps = _profiled_round(
            rec, lambda: self._round(self.active))
        self.pos += n_emit
        out = self._materialize_pending()
        self._metrics.record("step", time.perf_counter() - t0)
        return _end_round_step(self, rec,
                               _route_round(self, toks, n_emit, lps, out))

    def _slot_proposed(self, slot: int) -> int:
        return self.gamma

    def _note_round_result(self, slot: int, accepted: int,
                           proposed: int) -> None:
        pass

    @torch.no_grad()
    def warmup(self) -> None:
        """A dummy dual prefill for every prompt bucket and one idle
        round, before the first request. Only valid on an idle server."""
        self._warmup_buckets(lambda padded: self._prefill_slot(padded, 0, 1))
        self._round(np.zeros((self.n_slots,), bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _build_paged_spec_round(tcfg: ModelConfig, dcfg: ModelConfig, gamma: int,
                            dead_pos: int, attend_chunk=None,
                            lora_scale: float = 1.0):
    """The paged speculative round for one *gamma*: draft ``gamma`` greedy
    tokens through the dense per-slot draft cache at per-slot positions
    (``speculative.draft_propose``), verify them in one (gamma+1)-token
    target chunk through the pool (``paged.paged_forward_chunk``), and
    emit each slot's longest agreeing prefix plus the bonus or correction
    token, capped at the slot's own adaptive gamma.

    *dead_pos*: the draft-cache row an inactive slot's draft writes go to.
    A mid-prefill slot is inactive, but its draft rows already hold prompt
    KV that a write at its stale position would corrupt; row ``dead_pos``
    lies past every position a real query attends (writes past it clamp
    onto it). The target side sends inactive slots' writes to the pool's
    drop page (``write_enable``).

    ``round(t_params, d_params, k_store, v_store, dcache, table, last, pos,
    active, slot_gamma, lora, aids) -> (new_last, target_tok (B, gamma+1),
    n_emit (B,), lps (B, gamma+1))``, queued without a host sync; the
    caches are written in place. ``(lora, aids)`` is the target's
    multi-LoRA pair (each slot's adapter in the verify chunk; None for the
    plain server); the draft runs without adapters: a base-model draft can
    only lower acceptance, never change the greedy output."""

    @torch.no_grad()
    def round_all(t_params, d_params, k_store, v_store, dcache, table, last,
                  pos, active, slot_gamma, lora=None, aids=None):
        dk, dv = dcache
        pos_d = torch.where(active, pos, dead_pos)
        _, _, drafts = draft_propose(dcfg, gamma, d_params, dk, dv, last,
                                     pos_d)
        chunk = torch.cat([last[:, None], drafts], dim=1)
        t_logits = paged_forward_chunk(
            tcfg, t_params, chunk, k_store, v_store, table, pos,
            write_enable=active, attend_chunk=attend_chunk, lora=lora,
            adapter_ids=aids, lora_scale=lora_scale)
        target_tok = torch.argmax(t_logits, dim=-1)
        # a slot whose adaptive gamma sits below the round's emits at most
        # its own gamma of drafts: a prefix of an accepted run is still the
        # target's greedy stream
        accepted = torch.minimum(_accepted(drafts, target_tok), slot_gamma)
        n_emit = torch.where(active, accepted + 1, 0)
        new_last = torch.gather(target_tok, 1,
                                torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
        new_last = torch.where(active, new_last, last)
        return (new_last, target_tok, n_emit,
                chosen_logprob(t_logits, target_tok))

    return round_all


class PagedSpeculativeDecodeServer(_SpecRoundsMixin, PagedDecodeServer):
    """Speculative draft+verify rounds over the paged pool (port of the JAX
    package's ``PagedSpeculativeDecodeServer``): ``PagedDecodeServer``'s
    pool, chunked prefill, int8 pools and shared-prefix cache, with the
    one-token decode step replaced by a round, greedy token-exact against
    the plain server.

    - The verify chunk writes through the slot's table at positions
      ``>= pos``, strictly past any read-only shared prefix, so prefix
      hits, publication, reclamation and ``check_invariants`` behave as in
      the plain server.
    - A prefix hit starts the draft at the matched position with whatever
      its rows hold: that can lower acceptance, never change the output.
    - Reservations and the table width extend by ``gamma_max`` positions
      (``_seq_margin``): a round may write up to gamma tokens past the last
      accepted position, never rolled back.
    - Adaptive gamma (``adaptive_gamma``): a per-slot EMA of acceptance
      walks gamma in [1, gamma_max], reset at admission; ``slot_gammas()``
      reads it.
    - The verify chunk always attends through ``ops.paged_attention_chunk``
      (the kernel on the card, the plain version on the CPU).
    - Windowed configs are refused (a verify overshoot on a ring could
      evict a band entry a rewound position still reads), as are sampling
      overrides and ``overlap`` (a round emits a variable burst).
    - Live migration ships the target's pages and the slot's adaptive
      gamma and EMA; the draft's rows do not ship (stale draft KV can only
      lower acceptance).
    - ``mesh=``: the target is sharded as the plain paged server's (its
      verify chunk runs the chunk kernel on the rank's heads); the draft
      stays whole on every rank, as the JAX package places only the
      target."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 target_params: Transformer, draft_params: Transformer,
                 n_slots: int = 8, max_seq: int = 512,
                 max_new_tokens: int = 64, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: Optional[int] = None,
                 seed: int = 0, kv_int8: bool = False,
                 prefill_budget: int = 0, queue_ttl: Optional[float] = None,
                 prefix_cache_pages: int = 0, gamma_max: int = 4,
                 adaptive_gamma: bool = True, overlap: bool = False,
                 device=None, mesh=None) -> None:
        if target_cfg.vocab != draft_cfg.vocab:
            raise ValueError("target and draft must share a vocabulary")
        if target_cfg.window > 0 or draft_cfg.window > 0:
            raise NotImplementedError(
                "paged speculative serving does not compose with windowed "
                "configs: the ring table aliases logical pages, and a "
                "verify overshoot write could evict a band entry a rewound "
                "position still reads")
        if overlap:
            raise NotImplementedError(
                "paged speculative serving takes no overlap: a round emits "
                "a variable burst, and the one-step pipeline does not apply")
        if gamma_max < 1:
            raise ValueError("gamma_max must be >= 1")
        # read by _seq_margin() inside super().__init__ (table width and
        # worst-case reservations include the verify overshoot)
        self.gamma_max = int(gamma_max)
        self.adaptive_gamma = bool(adaptive_gamma)
        super().__init__(
            target_cfg, target_params, n_slots=n_slots, max_seq=max_seq,
            max_new_tokens=max_new_tokens, page_size=page_size,
            n_pages=n_pages, eos_id=eos_id, seed=seed, kv_int8=kv_int8,
            prefill_budget=prefill_budget, queue_ttl=queue_ttl,
            prefix_cache_pages=prefix_cache_pages, device=device, mesh=mesh)
        for p in draft_params.state_dict().values():
            if p.device.type != self.device.type:
                raise ValueError(f"draft params live on {p.device}, the "
                                 f"server on {self.device}")
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        # the draft's dense cache spans the target's table width, plus the
        # dead row: every prefill bucket the base admits fits, and the
        # round's deepest draft write (pos + gamma) stays below the dead row
        self._draft_len = self.max_pages_per_slot * page_size + 1
        self.dcache = init_kv_cache(draft_cfg, n_slots, self._draft_len,
                                    self.device)
        self._gamma = np.full((n_slots,), self.gamma_max, np.int64)
        self._accept_ema = np.ones((n_slots,), np.float64)
        _init_spec_obs(self)
        for s in range(n_slots):
            self.obs.gauge_fn("kubetpu_spec_gamma",
                              lambda s=s: float(self._gamma[s]),
                              slot=str(s))
        # the draft's prefill rides the dense server's legs
        self._draft_prefill, _ = _build_dense_legs(
            draft_cfg, _dense_cache_io(draft_cfg.window))

    # -- adaptive gamma -------------------------------------------------------

    def _seq_margin(self) -> int:
        return self.gamma_max

    def _round_leg(self, gamma: int):
        return _build_paged_spec_round(
            self.cfg, self.draft_cfg, gamma, self._draft_len - 1,
            attend_chunk=self._attend_chunk, lora_scale=self._lora_scale)

    def _note_admitted(self, slot: int, prompt: List[int]) -> None:
        super()._note_admitted(slot, prompt)
        # every request starts optimistic at gamma_max
        self._gamma[slot] = self.gamma_max
        self._accept_ema[slot] = 1.0

    def _update_gamma(self, slot: int, accepted: int, proposed: int) -> None:
        if not self.adaptive_gamma:
            return
        frac = accepted / max(proposed, 1)
        ema = (1.0 - _EMA_ALPHA) * self._accept_ema[slot] + _EMA_ALPHA * frac
        self._accept_ema[slot] = ema
        g = int(self._gamma[slot])
        if ema >= _GAMMA_UP and g < self.gamma_max:
            self._gamma[slot] = g + 1
            self.events.emit("gamma", slot=slot, old=g, new=g + 1,
                             ema=round(ema, 3))
        elif ema < _GAMMA_DOWN and g > 1:
            self._gamma[slot] = g - 1
            self.events.emit("gamma", slot=slot, old=g, new=g - 1,
                             ema=round(ema, 3))

    def slot_gammas(self) -> List[int]:
        """Each slot's current adaptive gamma (the ``kubetpu_spec_gamma``
        gauge's values)."""
        return [int(g) for g in self._gamma]

    # -- request lifecycle ----------------------------------------------------

    def _normalize_sampling(self, sampling):
        return _refuse_sampling(self, sampling)

    def _draft_chunk(self, tokens, slot: int, pos: int) -> None:
        """The draft's prefill of a chunk (1, T) at *pos* into the slot's
        dense rows (its logits are never read)."""
        self._draft_prefill(self.draft_params, self.dcache, tokens, slot, pos)

    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        """The target's chunk through the pool, then the same chunk into
        the draft's dense cache: both stay position-aligned whatever the
        admission path (monolithic, chunked, prefix hit)."""
        res = super()._prefill_chunk_device(prompt, slot, pos, take, final)
        if res is None:
            return None               # pool exhausted: nothing mutated
        bucket = self._chunk_bucket(pos, take, final)
        chunk = prompt[pos:pos + take] + [0] * (bucket - take)
        self._draft_chunk(self._upload(np.asarray([chunk], np.int64)), slot,
                          pos)
        return res

    def _device_step(self):
        raise NotImplementedError("paged speculative serving steps in rounds")

    def _device_round(self, gamma: int, active: np.ndarray):
        """Queue one round at *gamma* -> device (target_tok, n_emit,
        lps). With the profiler on, the leg is watched per gamma
        (``round[gamma=G]``): a walk onto a gamma not run before reads as
        a first call on its own leg."""
        round_all = self._round_leg(gamma)
        if self._profiler is not None:
            round_all = self._profiler.watch(f"round[gamma={gamma}]",
                                             round_all)
        self.last, toks, n_emit, lps = round_all(
            self.params, self.draft_params, self._k_store, self._v_store,
            self.dcache, self._table_on_device(), self.last,
            self._upload(self.pos.astype(np.int32)), self._upload(active),
            self._upload(self._gamma), *self._step_lora())
        return toks, n_emit, lps

    def step(self) -> Dict[int, List[int]]:
        """One speculative round for every active slot -> {rid: [tokens]};
        each request receives 1..gamma+1 tokens (clipped at EOS and
        max_new_tokens on the host; the device overshoot is never read).
        Admission runs the base scheduler first, monolithic or
        token-budget chunked, both composing with prefix hits."""
        rec = self._begin_profiled_step()
        self._schedule_prefills()
        if rec is not None:
            rec.mark("schedule")
        if not self.active.any():
            return _end_round_step(self, rec, self._materialize_pending())
        t0 = time.perf_counter()
        g = max(int(self._gamma[s]) for s in range(self.n_slots)
                if self.active[s])
        toks, n_emit, lps = _profiled_round(
            rec, lambda: self._device_round(g, self.active))
        self.pos += n_emit
        out = self._materialize_pending()
        self._metrics.record("step", time.perf_counter() - t0)
        return _end_round_step(self, rec,
                               _route_round(self, toks, n_emit, lps, out))

    def _slot_proposed(self, slot: int) -> int:
        return int(self._gamma[slot])

    def _note_round_result(self, slot: int, accepted: int,
                           proposed: int) -> None:
        self._update_gamma(slot, accepted, proposed)

    # -- live KV migration ----------------------------------------------------

    def _migration_kind(self) -> str:
        return "paged_spec"

    def snapshot_slot(self, rid: int, from_page: int = 0,
                      allow_frozen: bool = False) -> dict:
        """The paged snapshot plus the controller's state: the slot's
        adaptive gamma and acceptance EMA survive the handoff. The draft's
        rows do not ship (stale draft KV on the target can only lower
        acceptance; verification is greedy-exact)."""
        snap = super().snapshot_slot(rid, from_page=from_page,
                                     allow_frozen=allow_frozen)
        slot = self._slot_rid.index(rid)
        snap["draft_fp"] = reference_config_repr(self.draft_cfg)
        snap["spec"] = {"gamma": int(self._gamma[slot]),
                        "accept_ema": float(self._accept_ema[slot])}
        return snap

    def restore_slot(self, snap: dict, reason: str = "migrate"):
        if snap.get("draft_fp") != reference_config_repr(self.draft_cfg):
            raise ValueError(
                "snapshot draft config does not match this server's — "
                "migration requires config-identical replicas")
        rid = super().restore_slot(snap, reason=reason)
        if rid is None:
            return None
        spec = snap.get("spec") or {}
        slot = self._slot_rid.index(rid)
        # _note_admitted reset the controller; the snapshot's state wins
        self._gamma[slot] = min(max(int(spec.get("gamma", self.gamma_max)),
                                    1), self.gamma_max)
        self._accept_ema[slot] = float(spec.get("accept_ema", 1.0))
        return rid

    @torch.no_grad()
    def warmup(self) -> None:
        """The plain server's warmup (target prompt buckets and a decode
        step; flushes the prefix tree), then the draft's buckets and one
        idle round at every gamma the controller can pick."""
        super().warmup()
        self._warmup_buckets(lambda padded: self._draft_chunk(
            self._upload(np.zeros((1, len(padded)), np.int64)), 0, 0))
        gammas = (range(1, self.gamma_max + 1) if self.adaptive_gamma
                  else (self.gamma_max,))
        idle = np.zeros((self.n_slots,), bool)
        for g in gammas:
            self._device_round(g, idle)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
