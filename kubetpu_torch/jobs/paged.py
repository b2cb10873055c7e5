"""Paged KV cache: serving memory proportional to live tokens (port of
``kubetpu/jobs/paged.py``).

- pool: ``k_pages/v_pages (L, n_pages, page_size, H_kv, D)``, or int8
  ``(values, scales (..., H_kv, 1) f32)`` pairs with ``kv_int8``;
- per-slot page table ``(n_slots, max_pages_per_slot)`` int32 mapping a
  slot's logical page to a physical pool page (-1 = unmapped);
- the host owns allocation (a free list): a request maps pages as its
  prompt streams in, and holds its worst case (prompt + max_new_tokens)
  once decoding, so decoding never starves mid-sequence.

Both legs of the serving path — the decode step (``paged_forward_one``)
and every prefill chunk (``forward_chunk_io`` over ``_paged_prefill_io``) —
attend through ``kubetpu_torch.ops.paged_attention``: the hand-written CUDA
kernel on the card, its plain PyTorch version on the CPU. K/V pages are
written in place before the attention reads them, on the same stream; the
JAX package's functional ``.at[].set`` returns a new pool per layer, the
in-place write saves that copy every step.

Not ported yet (later slices): the prefix cache and host tier, the
windowed ring table (``cfg.window > 0`` raises), ``pool_frac``, meshes,
snapshot/restore for migration, LoRA and the obs registry.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import numpy as np
import torch

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.decode import _attend_cached, _layer, forward_chunk_io
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.quant import quantize_kv_chunk
from kubetpu_torch.jobs.sampling import (chosen_logprob, make_slot_sampler,
                                         row_seed)
from kubetpu_torch.jobs.serving import SlotServerBase
from kubetpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_chunk)


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   kv_int8: bool = False, device=None):
    """(k_pages, v_pages), each (L, n_pages, page_size, H_kv, D) in
    ``cfg.dtype`` — or, with ``kv_int8``, each an (int8 values, f32 scales
    (..., H_kv, 1)) pair."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads, cfg.head_dim)

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if kv_int8:
        sshape = shape[:-1] + (1,)
        return ((zeros(shape, torch.int8), zeros(sshape, torch.float32)),
                (zeros(shape, torch.int8), zeros(sshape, torch.float32)))
    return zeros(shape, cfg.dtype), zeros(shape, cfg.dtype)


def _gather_pages(pages_l, safe):
    """A slot's pages from a dense layer or an int8 (values, scales) pair;
    int8 dequantizes the gathered slice only: convert, then scale, in f32."""
    if isinstance(pages_l, tuple):
        q8, sc = pages_l
        return q8[safe].float() * sc[safe]
    return pages_l[safe]


def _attend_paged(q, k_pages_l, v_pages_l, table, pos, window: int = 0):
    """The JAX package's gather core for one query per slot: q (B, H, D);
    table (B, max_pages) (-1 unmapped, clamped to 0 for the gather then
    masked); pos (B,). f32 scores and softmax over the gathered pages."""
    b, h, d = q.shape
    vals = k_pages_l[0] if isinstance(k_pages_l, tuple) else k_pages_l
    ps, h_kv = vals.shape[1], vals.shape[2]
    g = h // h_kv
    max_pages = table.shape[1]
    safe = torch.clamp(table, min=0).long()
    k = _gather_pages(k_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    v = _gather_pages(v_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    qg = q.reshape(b, h_kv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d ** -0.5
    k_pos = torch.arange(max_pages * ps, device=q.device)
    mask = k_pos[None, :] <= pos.long()[:, None]
    if window > 0:
        mask = mask & (pos.long()[:, None] - k_pos[None, :] < window)
    mask = mask & torch.repeat_interleave(table >= 0, ps, dim=1)
    scores = scores.masked_fill(~mask[:, None, None, :], model_lib.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def _attend_paged_chunk(q, k_pages_l, v_pages_l, table, pos):
    """``_attend_paged`` for T queries per slot at ``pos..pos+T-1``:
    q (B, T, H, D)."""
    b, t, h, d = q.shape
    vals = k_pages_l[0] if isinstance(k_pages_l, tuple) else k_pages_l
    ps, h_kv = vals.shape[1], vals.shape[2]
    g = h // h_kv
    max_pages = table.shape[1]
    safe = torch.clamp(table, min=0).long()
    k = _gather_pages(k_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    v = _gather_pages(v_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    qg = q.reshape(b, t, h_kv, g, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * d ** -0.5
    k_pos = torch.arange(max_pages * ps, device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(t, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    mask = mask & torch.repeat_interleave(table >= 0, ps, dim=1)[:, None, :]
    scores = scores.masked_fill(~mask[:, None, None], model_lib.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _write_token_kv(pages_l, new, phys_page, offset):
    """Write one token's K or V per row into its page, in place.
    pages_l: (P, ps, H_kv, D) or the int8 (values, scales) pair, where the
    token quantizes at write time; new: (N, H_kv, D); phys_page/offset: (N,)
    and every phys_page inside the pool. The JAX package drops the
    out-of-range sentinel with ``mode="drop"``; torch indexing has no such
    mode (a negative index would wrap onto a live page), so the caller
    filters those rows out first (``paged_forward_one``)."""
    if isinstance(pages_l, tuple):
        q8, sc = pages_l
        n8, ns = quantize_kv_chunk(new)
        q8[phys_page, offset] = n8
        sc[phys_page, offset] = ns
    else:
        pages_l[phys_page, offset] = new.to(pages_l.dtype)


@torch.no_grad()
def paged_forward_one(cfg: ModelConfig, params: Transformer, token, k_pages,
                      v_pages, table, pos, attend=_attend_paged,
                      write_enable=None):
    """One decode step for all slots through the page pool. token: (B,)
    int; pos: (B,) int32 position of this token; table: (B, max_pages)
    int32. Returns logits (B, V) f32; the pools are written in place.
    *attend* is the page-attention core. *write_enable* (B,) bool drops
    the K/V write of masked slots (inactive slots must never scribble on
    pages a mid-prefill neighbour has filled). Rows whose page is unmapped
    or disabled are dropped once, before the layer loop: the one host sync
    of the step happens there, before any layer work is queued."""
    vals = k_pages[0] if isinstance(k_pages, tuple) else k_pages
    ps = vals.shape[2]
    pos_l = pos.long()
    lp = torch.clamp(pos_l // ps, max=table.shape[1] - 1)
    phys = torch.gather(table, 1, lp[:, None])[:, 0].long()
    keep = phys >= 0
    if write_enable is not None:
        keep = keep & write_enable
    rows = torch.nonzero(keep)[:, 0]
    phys, offset = phys[rows], (pos_l % ps)[rows]
    x = params.embed[token][:, None]                        # (B, 1, D)
    positions = pos_l[:, None]
    for i, layer in enumerate(params.blocks):
        k_l, v_l = _layer(k_pages, i), _layer(v_pages, i)
        h = model_lib.rms_norm(x, layer.ln1)
        q = torch.einsum("bsd,dhk->bshk", h, layer.wq)
        k = torch.einsum("bsd,dhk->bshk", h, layer.wk)
        v = torch.einsum("bsd,dhk->bshk", h, layer.wv)
        q = model_lib.rope(q, positions, cfg.rope_theta,
                           cfg.rope_llama3_scaling)
        k = model_lib.rope(k, positions, cfg.rope_theta,
                           cfg.rope_llama3_scaling)
        _write_token_kv(k_l, k[rows, 0], phys, offset)
        _write_token_kv(v_l, v[rows, 0], phys, offset)
        attn = attend(q[:, 0].contiguous(), k_l, v_l, table, pos)
        x = x + torch.einsum("bhk,hkd->bd", attn, layer.wo)[:, None]
        x = x + model_lib._mlp(cfg, model_lib.rms_norm(x, layer.ln2), layer)
    x = model_lib.rms_norm(x, params.ln_f)
    return torch.einsum("bsd,dv->bsv", x, params.head).float()[:, 0]


def _paged_prefill_io(write_phys, gather_row, ps: int, window: int,
                      attend_chunk=None):
    """The page-pool cache strategy of a prefill chunk, for
    ``decode.forward_chunk_io`` (batch 1, chunk at position ``pos``).

    *write_phys* (n_write,): the physical page of each chunk page; entries
    equal to the pool size (the sentinel: pad-only pages) are dropped. The
    server hands it over as a CPU tensor, so picking the kept pages costs
    no device sync. *gather_row*: a prefix of the slot's logical table
    covering the chunk's visible positions, on the pool's device.

    With *attend_chunk* (the kernel path) the chunk's K/V are written to
    the pool first and the queries attend through the table — sound because
    the chunk's pages are disjoint from every earlier page. Without it (the
    gather path, the JAX package's order) the pool is gathered before the
    write, the chunk's own K/V are patched into the contiguous view, and
    ``_attend_cached`` reads it. int8 pools quantize on write, and the
    patched view is the dequantized quantized chunk, so both paths read the
    same values."""
    n_write = write_phys.shape[0]

    def split(pages_l, new):
        """(pool write payload, contiguous attend payload) for the chunk."""
        if isinstance(pages_l, tuple):
            n8, ns = quantize_kv_chunk(new)
            return (n8, ns), n8.float() * ns
        return new.to(pages_l.dtype), new

    kept = None     # (chunk pages kept, their physical pages), on the pool

    def scatter(pages_l, payload):
        nonlocal kept
        dense = not isinstance(pages_l, tuple)
        dsts = (pages_l,) if dense else pages_l
        srcs = (payload,) if dense else payload
        if kept is None:
            dev = dsts[0].device
            sel = torch.nonzero(write_phys < dsts[0].shape[0])[:, 0]
            kept = (sel.to(dev, non_blocking=True),
                    write_phys[sel].to(dev, non_blocking=True))
        sel, phys = kept
        for dst, src in zip(dsts, srcs):
            dst[phys] = src[0].reshape(n_write, ps, *src.shape[2:])[sel]

    if attend_chunk is not None:
        def io(q, k, v, cache, pos):
            k_l, v_l = cache
            scatter(k_l, split(k_l, k)[0])
            scatter(v_l, split(v_l, v)[0])
            pos_t = torch.full((1,), pos, dtype=torch.int32, device=q.device)
            return attend_chunk(q, k_l, v_l, gather_row[None], pos_t), cache

        return io

    def io(q, k, v, cache, pos):
        k_l, v_l = cache
        k_pool, k_att = split(k_l, k)
        v_pool, v_att = split(v_l, v)
        safe = torch.clamp(gather_row, min=0).long()
        kk = _gather_pages(k_l, safe)          # (n_gather, ps, H_kv, D)
        vv = _gather_pages(v_l, safe)
        kk = kk.reshape(1, -1, *kk.shape[2:]).clone()
        vv = vv.reshape(1, -1, *vv.shape[2:]).clone()
        t = q.shape[1]
        kk[:, pos:pos + t] = k_att.to(kk.dtype)
        vv[:, pos:pos + t] = v_att.to(vv.dtype)
        attn = _attend_cached(q, kk, vv, pos, window=window)
        scatter(k_l, k_pool)
        scatter(v_l, v_pool)
        return attn, cache

    return io


class PagedDecodeServer(SlotServerBase):
    """Continuous batching over a paged KV cache (port of the JAX
    package's ``PagedDecodeServer``): ``SlotServerBase``'s request
    lifecycle, with cache memory proportional to live tokens.

    ``n_pages`` provisions the shared pool (default: half the dense
    equivalent). A decoding request holds its worst case (prompt +
    max_new_tokens + 1), so it never starves mid-flight, and a request whose
    worst case exceeds the whole pool is refused up front. With
    ``prefill_budget > 0`` prompts stream in as page-aligned chunks and a
    mid-prefill slot holds pages only for the tokens written so far; the
    final chunk upgrades the reservation to the decode worst case.

    The attention of both legs goes through the paged-attention kernel on
    the card and through its plain version on the CPU; there is no switch.
    ``device`` defaults to the card and raises without CUDA; *params* must
    already live on it. Windowed configs (``cfg.window > 0``) need the ring
    page table, which is not ported yet."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 n_slots: int = 8, max_seq: int = 512,
                 max_new_tokens: int = 64, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 kv_int8: bool = False, prefill_budget: int = 0,
                 device=None) -> None:
        device = resolve_device(device)
        if cfg.window > 0:
            raise NotImplementedError(
                "windowed serving (cfg.window > 0) needs the ring page "
                "table, not ported to kubetpu_torch yet (ROADMAP queue 1, "
                "item 5: paged serving)")
        for p in params.parameters():
            if p.device.type != device.type:
                raise ValueError(f"params live on {p.device}, the server "
                                 f"on {device}")
        super().__init__(cfg, params, n_slots, max_seq, max_new_tokens,
                         eos_id, temperature=temperature, top_k=top_k,
                         top_p=top_p, seed=seed,
                         prefill_budget=prefill_budget, device=device)
        self.page_size = page_size
        self._min_bucket = page_size
        self.max_pages_per_slot = (max_seq + page_size - 1) // page_size
        self.pool_pages = n_pages or (
            n_slots * self.max_pages_per_slot + 1) // 2
        self.kv_int8 = kv_int8
        self.k_pages, self.v_pages = init_page_pool(
            cfg, self.pool_pages, page_size, kv_int8=kv_int8, device=device)
        self._free: List[int] = list(range(self.pool_pages))
        self._table = np.full((n_slots, self.max_pages_per_slot), -1,
                              np.int32)
        self._table_dev: Optional[torch.Tensor] = None   # device mirror
        self._sampler = make_slot_sampler()
        self._attend = partial(paged_attention, window=cfg.window)

    # -- page accounting -----------------------------------------------------

    def pages_in_use(self) -> int:
        return self.pool_pages - len(self._free)

    def _pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def _worst_case_tokens(self, prompt_len: int) -> int:
        return prompt_len + self.max_new_tokens + 1

    def _alloc_pages(self, slot: int, upto_tokens: int) -> bool:
        """Map pages so *slot* can hold *upto_tokens* tokens; False (nothing
        mapped) when the pool cannot cover them."""
        need = self._pages_needed(upto_tokens)
        have = int((self._table[slot] >= 0).sum())
        if need - have > len(self._free):
            return False
        if need > have:
            for lp in range(have, need):
                self._table[slot, lp] = self._free.pop()
            self._table_dev = None
        return True

    def _release_pages(self, slot: int) -> None:
        """Unmap the slot's table; its pages return to the free list."""
        for lp in range(self.max_pages_per_slot):
            phys = int(self._table[slot, lp])
            if phys >= 0:
                self._free.append(phys)
            self._table[slot, lp] = -1
        self._table_dev = None

    def _table_on_device(self) -> torch.Tensor:
        """The page table on the device, uploaded again only after the host
        table changed."""
        if self._table_dev is None:
            self._table_dev = self._upload(self._table)
        return self._table_dev

    # -- lifecycle hooks -----------------------------------------------------

    def _check_prompt(self, prompt: List[int]) -> None:
        super()._check_prompt(prompt)
        need = self._pages_needed(self._worst_case_tokens(len(prompt)))
        if need > self.pool_pages:
            raise ValueError(
                f"request needs {need} pages worst-case but the pool has "
                f"only {self.pool_pages} — raise n_pages or lower "
                f"max_new_tokens")

    def _on_retire(self, slot: int) -> None:
        self._release_pages(slot)

    def load_info(self) -> dict:
        info = super().load_info()
        info["pool_pages"] = self.pool_pages
        info["pages_free"] = len(self._free)
        info["pages_in_use"] = self.pages_in_use()
        return info

    def check_invariants(self) -> None:
        """The pool accounting oracle: every physical page is owned by
        exactly one of {the free list, one slot's table}; a slot holding
        pages is decoding or mid-prefill. AssertionError on a violation."""
        free = list(self._free)
        free_set = set(free)
        assert len(free) == len(free_set), "free list holds a page twice"
        assert free_set <= set(range(self.pool_pages)), \
            "free list holds an out-of-range page"
        owned = set()
        for slot in range(self.n_slots):
            row = [int(p) for p in self._table[slot] if p >= 0]
            if row:
                assert self.active[slot] or slot in self._prefills, \
                    f"idle slot {slot} still maps pages {row}"
            for phys in row:
                assert phys not in owned, \
                    f"page {phys} mapped by two slots"
                assert phys not in free_set, \
                    f"page {phys} both mapped and free"
                owned.add(phys)
        assert len(free_set) + len(owned) == self.pool_pages, (
            f"pages leaked: free {len(free_set)} + slots {len(owned)} != "
            f"pool {self.pool_pages}")

    # -- device legs ---------------------------------------------------------

    def _chunk_quantum(self) -> int:
        return self.page_size       # chunk starts stay page-aligned

    def _chunk_bucket(self, pos: int, take: int, final: bool) -> int:
        """Padded chunk length: final chunks bucket-pad (page-rounded, pad
        K/V land where decode overwrites before any read; pad-only pages
        are dropped), non-final chunks page-round."""
        ps = self.page_size
        if final:
            bucket = ((self._bucket(take) + ps - 1) // ps) * ps
            if pos + bucket > self.max_pages_per_slot * ps:
                bucket = ((take + ps - 1) // ps) * ps
            return bucket
        return ((take + ps - 1) // ps) * ps

    def _gather_prefix(self, upto_tokens: int) -> int:
        """Power-of-two page count covering *upto_tokens* positions, capped
        at the slot's table: the chunk attends only pages it can see."""
        n = 1
        while n * self.page_size < upto_tokens:
            n *= 2
        return min(n, self.max_pages_per_slot)

    def _admit_device(self, prompt: List[int], slot: int):
        """Whole-prompt prefill as one final chunk."""
        return self._prefill_chunk_device(prompt, slot, 0, len(prompt), True)

    @torch.no_grad()
    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        """One page-aligned prefill chunk through the pool, with
        chunk-granular page reservation (the final chunk reserves the
        decode worst case). None when the pool cannot cover it (nothing
        mapped), True for a non-final chunk, the first token and its
        logprob (device scalars) for the final one."""
        upto = self._worst_case_tokens(len(prompt)) if final else pos + take
        if not self._alloc_pages(slot, upto):
            return None
        ps = self.page_size
        bucket = self._chunk_bucket(pos, take, final)
        chunk = prompt[pos:pos + take] + [0] * (bucket - take)
        n_write = (bucket + ps - 1) // ps
        p0 = pos // ps
        row = self._table[slot]
        write_row = row[p0:p0 + n_write].astype(np.int64)
        # pad-only pages (no real token) are dropped: a pad write must never
        # land on an unreserved page
        last_real = (pos + take - 1) // ps - p0
        write_row[last_real + 1:] = -1
        write_phys = torch.from_numpy(
            np.where(write_row >= 0, write_row, self.pool_pages))
        n_gather = self._gather_prefix(pos + bucket)
        io = _paged_prefill_io(write_phys,
                               self._upload(np.ascontiguousarray(
                                   row[:n_gather])),
                               ps, self.cfg.window,
                               attend_chunk=paged_attention_chunk)
        tokens = self._upload(np.asarray([chunk], np.int64))
        logits, _ = forward_chunk_io(self.cfg, self.params, tokens,
                                     (self.k_pages, self.v_pages), pos, io)
        if not final:
            return True
        r = logits[0, take - 1]
        temp, tk, tp = self._slot_sampling(slot)
        tok = self._sampler(r, temp, tk, tp,
                            row_seed(self._slot_reqkey[slot], pos + take - 1))
        return tok, chosen_logprob(r, tok)

    @torch.no_grad()
    def _device_step(self):
        """One decode step for every slot; worst-case pages were reserved at
        admission, so boundary crossings never fail. The real table (with
        -1 holes) goes to the device; the attention masks unmapped pages."""
        active = self._upload(self.active)
        pos = self._upload(self.pos.astype(np.int32))
        logits = paged_forward_one(
            self.cfg, self.params, self.last, self.k_pages, self.v_pages,
            self._table_on_device(), pos, attend=self._attend,
            write_enable=active)
        seeds = None                       # all-greedy: no draw needs one
        if (self._slot_temp > 0).any():
            seeds = [row_seed(self._slot_reqkey[s], int(self.pos[s]))
                     for s in range(self.n_slots)]
        nxt = self._sampler(logits, self._slot_temp, self._slot_topk,
                            self._slot_topp, seeds)
        nxt = torch.where(active, nxt, self.last)
        lp = chosen_logprob(logits, nxt)
        self.pos += self.active
        self.last = nxt
        return nxt, lp
