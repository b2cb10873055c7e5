"""Paged KV cache: serving memory proportional to live tokens (port of
``kubetpu/jobs/paged.py``).

- pool: ``k_pages/v_pages (L, n_pages, page_size, H_kv, D)``, or int8
  ``(values, scales (..., H_kv, 1) f32)`` pairs with ``kv_int8``;
- per-slot page table ``(n_slots, max_pages_per_slot)`` int32 mapping a
  slot's logical page to a physical pool page (-1 = unmapped);
- the host owns allocation (a free list): a request maps pages as its
  prompt streams in, and holds its worst case (prompt + max_new_tokens)
  once decoding, so decoding never starves mid-sequence.

Every leg of the serving path — the decode step (``paged_forward_one``),
the speculative verify chunk (``paged_forward_chunk``) and every prefill
chunk (``forward_chunk_io`` over ``_paged_prefill_io``) — attends through
``kubetpu_torch.ops.paged_attention``: the hand-written CUDA kernel on the
card, its plain PyTorch version on the CPU. K/V pages are written in place
before the attention reads them, on the same stream; the JAX package's
functional ``.at[].set`` returns a new pool per layer, the in-place write
saves that copy every step.

The server's pools hold one page past the pool the table addresses: the
drop page (index ``pool_pages``). A write the JAX package drops with
``mode="drop"`` (an unmapped page, an inactive slot) lands there instead,
so the step picks its kept rows without a host sync; no table maps the
drop page and nothing reads it. ``k_pages`` / ``v_pages`` are views of the
addressable pages.

Windowed configs run on a per-slot ring of physical pages, shared-prefix
reuse maps cached pages read-only through the radix tree of
``prefix_cache``, the host DRAM tier keeps evicted prefixes as CPU tensors,
and live migration ships a slot's pages as stored (``PagedDecodeServer``).

Every leg takes each slot's LoRA adapter deltas around the attention
(``lora``, ``adapter_ids``): ``multi_lora.PagedMultiLoraDecodeServer``
feeds them through the ``_admit_lora`` / ``_step_lora`` hooks, the plain
server feeds none and runs no LoRA op.

Over a mesh (``PagedDecodeServer(..., mesh=)``) the parameters are a tp
shard and the pool holds each rank's ``H_kv/tp`` heads; the page axis is
not sharded and the pool is replicated over dp (the JAX package's
layout), so table gathers stay local and every rank runs every slot. The
split, combine and chunk kernels run on the rank's heads. Snapshots and
exported spans gather the heads over tp (the whole array, as the JAX
package's ``device_get`` of a sharded pool returns it); restores and
injected spans keep each rank's heads; the host tier holds each rank's
own heads.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.decode import (_attend_cached, _head, _layer,
                                       forward_chunk_io, lora_layer,
                                       out_project, project, select_lora)
from kubetpu_torch.jobs.model import (ModelConfig, Transformer,
                                      reference_config_repr, resolve_device)
from kubetpu_torch.jobs.prefix_cache import RadixPrefixCache
from kubetpu_torch.jobs.quant import maybe_dequantize, quantize_kv_chunk
from kubetpu_torch.jobs.sampling import (chosen_logprob, make_slot_sampler,
                                         row_seed)
from kubetpu_torch.jobs.serving import SlotServerBase, to_device
from kubetpu_torch.ops.paged_attention import (paged_attention,
                                               paged_attention_chunk)


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   kv_int8: bool = False, device=None, tp: int = 1):
    """(k_pages, v_pages), each (L, n_pages, page_size, H_kv, D) in
    ``cfg.dtype`` — or, with ``kv_int8``, each an (int8 values, f32 scales
    (..., H_kv, 1)) pair; a tp rank's pool holds ``H_kv/tp`` heads."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.kv_heads // tp,
             cfg.head_dim)

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if kv_int8:
        sshape = shape[:-1] + (1,)
        return ((zeros(shape, torch.int8), zeros(sshape, torch.float32)),
                (zeros(shape, torch.int8), zeros(sshape, torch.float32)))
    return zeros(shape, cfg.dtype), zeros(shape, cfg.dtype)


def _host_array(t: torch.Tensor):
    """A CPU page tensor in the form spans and snapshots travel in: numpy,
    the JAX package's form, for every stored dtype numpy has; a bfloat16
    tensor stays a tensor (the wire codec writes its 16-bit patterns)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _cpu_tensor(arr) -> torch.Tensor:
    """A shipped page array (numpy, or a bfloat16 tensor) as a CPU
    tensor."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


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


def _pool_view(store, n_pages: int):
    """The first *n_pages* pages of a pool store (dense, or an int8
    (values, scales) pair): views, written through in place."""
    if isinstance(store, tuple):
        return tuple(t[:, :n_pages] for t in store)
    return store[:, :n_pages]


def _write_token_kv(pages_l, new, phys_page, offset):
    """Write tokens' K or V into their pages, in place. pages_l:
    (P, ps, H_kv, D) or the int8 (values, scales) pair, where the tokens
    quantize at write time; new: (*N, H_kv, D); phys_page/offset: (*N,),
    every phys_page inside the pool. torch indexing has no ``mode="drop"``
    (a negative index would wrap onto a live page): the callers send a
    dropped row to the drop page instead."""
    if isinstance(pages_l, tuple):
        q8, sc = pages_l
        n8, ns = quantize_kv_chunk(new)
        q8[phys_page, offset] = n8
        sc[phys_page, offset] = ns
    else:
        pages_l[phys_page, offset] = new.to(pages_l.dtype)


def _write_targets(k_pages, table, tpos, write_enable):
    """(physical page, offset) of each token at positions tpos (B, T)
    through the table, computed on the device: a token whose page is
    unmapped or past the table, or whose slot *write_enable* (B,) masks,
    goes to the drop page (the pools' last page)."""
    vals = k_pages[0] if isinstance(k_pages, tuple) else k_pages
    ps, drop = vals.shape[2], vals.shape[1] - 1
    lp = tpos // ps
    phys = torch.gather(table, 1,
                        torch.clamp(lp, max=table.shape[1] - 1)).long()
    keep = (phys >= 0) & (lp < table.shape[1])
    if write_enable is not None:
        keep = keep & write_enable[:, None]
    return torch.where(keep, phys, drop), tpos % ps


def _paged_forward(cfg: ModelConfig, params: Transformer, tokens, k_pages,
                   v_pages, table, pos, attend, write_enable, lora=None,
                   adapter_ids=None, lora_scale: float = 1.0):
    """The body of both pool legs: tokens (B, T) at per-slot positions
    pos..pos+T-1, each layer's K/V written through the table first (a
    dropped write to the drop page), then ``attend(q (B, T, H, D), k_l,
    v_l, table, pos)`` -> (B, T, H, D) reads them. Logits (B, T, V) f32.
    ``lora`` + ``adapter_ids`` (B,): each slot's adapter deltas around the
    attention, as ``decode.forward_chunk_io`` applies them (the factors
    gathered once a forward). An int8 model dequantizes one layer at a time
    here, and the head per use. A model shard (``Transformer.shard``) runs
    its heads tensor-parallel: ``copy_to`` before the projections,
    ``reduce_from`` after ``wo`` (with its LoRA delta) and the MLP, and the
    logits gathered whole."""
    shard = getattr(params, "shard", None)
    tp = None if shard is None else shard.tp
    t = tokens.shape[1]
    tpos = pos.long()[:, None] + torch.arange(t, device=pos.device)
    phys, offset = _write_targets(k_pages, table, tpos, write_enable)
    x = params.embed[tokens]                                 # (B, T, D)
    sel = select_lora(lora, adapter_ids)
    for i, layer in enumerate(params.blocks):
        k_l, v_l = _layer(k_pages, i), _layer(v_pages, i)
        lora_l = lora_layer(sel, i)
        layer = maybe_dequantize(layer)
        h = col.copy_to(model_lib.rms_norm(x, layer.ln1), tp)
        q = project("wq", h, layer.wq, lora_l, lora_scale)
        k = project("wk", h, layer.wk, lora_l, lora_scale)
        v = project("wv", h, layer.wv, lora_l, lora_scale)
        q = model_lib.rope(q, tpos, cfg.rope_theta, cfg.rope_llama3_scaling)
        k = model_lib.rope(k, tpos, cfg.rope_theta, cfg.rope_llama3_scaling)
        _write_token_kv(k_l, k, phys, offset)
        _write_token_kv(v_l, v, phys, offset)
        attn = attend(q, k_l, v_l, table, pos)
        x = x + col.reduce_from(
            out_project(attn, layer.wo, lora_l, lora_scale), tp)
        delta, _aux = model_lib._mlp(cfg, model_lib.rms_norm(x, layer.ln2),
                                     layer, shard=shard)
        x = x + delta
    return _head(params, x, shard)


@torch.no_grad()
def paged_forward_one(cfg: ModelConfig, params: Transformer, token, k_pages,
                      v_pages, table, pos, attend=_attend_paged,
                      write_enable=None, lora=None, adapter_ids=None,
                      lora_scale: float = 1.0):
    """One decode step for all slots through the page pool. token: (B,)
    int; pos: (B,) int32 position of this token; table: (B, max_pages)
    int32 over the pool's addressable pages; k_pages/v_pages: the pool
    stores, whose last page is the drop page. Returns logits (B, V) f32;
    the pools are written in place. *attend* is the one-query
    page-attention core (q (B, H, D)). *write_enable* (B,) bool drops the
    K/V write of masked slots (inactive slots must never scribble on pages
    a mid-prefill neighbour has filled): it and an unmapped page's write
    land on the drop page, so the step queues without a host sync.
    ``lora`` + ``adapter_ids`` (B,): each slot's adapter deltas."""
    def attend_one(q, k_l, v_l, table, pos):
        return attend(q[:, 0].contiguous(), k_l, v_l, table, pos)[:, None]

    return _paged_forward(cfg, params, token[:, None], k_pages, v_pages,
                          table, pos, attend_one, write_enable, lora,
                          adapter_ids, lora_scale)[:, 0]


@torch.no_grad()
def paged_forward_chunk(cfg: ModelConfig, params: Transformer, tokens,
                        k_pages, v_pages, table, pos, write_enable=None,
                        attend_chunk=None, lora=None, adapter_ids=None,
                        lora_scale: float = 1.0):
    """The T-token chunk of every slot through the page pool at per-slot
    positions ``pos..pos+T-1``: the speculative verify leg (T = gamma+1;
    ``paged_forward_one`` is its T == 1 sibling). tokens: (B, T); pos:
    (B,) int32; k_pages/v_pages: the pool stores (the drop page last).
    Returns logits (B, T, V) f32; the pools are written in place.

    The chunk's K/V are written first, then the queries attend through the
    table under the positional mask, so in-chunk causality is the mask's
    job and an int8 pool's queries read the quantized in-chunk entries, as
    a one-token decode step would read them back. Rejected tokens' entries
    are never rolled back: positions rewind, and the mask never reads past
    a query's position until the position is fed again and overwritten.
    *write_enable* (B,) bool sends an inactive slot's writes to the drop
    page, as an unmapped page's, without a host sync. *attend_chunk* is
    the chunk attention core (``ops.paged_attention_chunk``: the kernel on
    the card, its plain version on the CPU; ``_attend_paged_chunk`` by
    default). ``lora`` + ``adapter_ids`` (B,): each slot's adapter deltas
    (the multi-LoRA verify chunk)."""
    return _paged_forward(cfg, params, tokens, k_pages, v_pages, table, pos,
                          attend_chunk or _attend_paged_chunk, write_enable,
                          lora, adapter_ids, lora_scale)


def _paged_prefill_io(write_phys, gather_row, ps: int, window: int,
                      attend_chunk=None):
    """The page-pool cache strategy of a prefill chunk, for
    ``decode.forward_chunk_io`` (batch 1, chunk at position ``pos``).

    *write_phys* (n_write,): the physical page of each chunk page; entries
    past the pool (pad-only pages) are dropped. It is a CPU tensor, so the
    kept pages are picked on the host and staged to the card without a
    device sync. *gather_row*: a prefix of the slot's logical table
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

    def pool_payload(pages_l, new):
        """The chunk's K or V as the pool stores it (int8 pools quantize)."""
        if isinstance(pages_l, tuple):
            return quantize_kv_chunk(new)
        return new.to(pages_l.dtype)

    def split(pages_l, new):
        """(pool write payload, contiguous attend payload) for the chunk on
        the gather path; an int8 chunk attends its dequantized values."""
        payload = pool_payload(pages_l, new)
        if isinstance(pages_l, tuple):
            n8, ns = payload
            return payload, n8.float() * ns
        return payload, new

    kept = None     # (chunk pages kept, their physical pages), on the pool

    def scatter(pages_l, payload):
        nonlocal kept
        dense = not isinstance(pages_l, tuple)
        dsts = (pages_l,) if dense else pages_l
        srcs = (payload,) if dense else payload
        if kept is None:
            dev = dsts[0].device
            wp = write_phys.numpy()
            sel = np.flatnonzero(wp < dsts[0].shape[0])
            kept = (to_device(sel, dev), to_device(wp[sel], dev))
        sel, phys = kept
        for dst, src in zip(dsts, srcs):
            dst[phys] = src[0].reshape(n_write, ps, *src.shape[2:])[sel]

    if attend_chunk is not None:
        def io(q, k, v, cache, pos):
            k_l, v_l = cache
            scatter(k_l, pool_payload(k_l, k))
            scatter(v_l, pool_payload(v_l, v))
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
    equivalent), scaled by ``pool_frac`` (this replica's share of a card).
    A decoding request holds its worst case (prompt + max_new_tokens + 1),
    so it never starves mid-flight, and a request whose worst case exceeds
    the whole pool is refused up front. With ``prefill_budget > 0`` prompts
    stream in as page-aligned chunks and a mid-prefill slot holds pages
    only for the tokens written so far; the final chunk upgrades the
    reservation to the decode worst case.

    Windowed configs (``cfg.window > 0``) map each slot's logical pages
    onto a physical RING of ``ceil(window / ps) + 1`` pages (logical page
    lp -> ring[lp % ring]): the token overwritten at position p sits at
    p - ring * ps <= p - window - 1, outside every later band, so a slot
    costs O(window) pages however long it runs. Windowed prefill chunks
    gather the pool before they write (the chunk's pages would evict the
    window's tail), so they never take the chunk kernel.

    ``prefix_cache_pages > 0`` turns on shared-prefix reuse
    (``prefix_cache.RadixPrefixCache``): an admission maps the longest
    cached full-page prefix read-only as the slot's leading table rows and
    starts prefill past it (capped one token short of the prompt: the last
    token must be forwarded to sample); a retiring slot donates its full
    prompt pages to the tree; under pool pressure evictable tree pages are
    reclaimed before an admission is refused. ``host_tier_bytes > 0`` adds
    the host DRAM tier: evicted spans are copied to host buffers instead of
    dropped and filled back on a later match. ``export_prefix_span`` /
    ``inject_prefix`` move a span between replicas in the stored layout of
    the JAX package (numpy arrays; a bf16 pool's pages as bf16 tensors).

    Live migration (``snapshot_slot`` / ``restore_slot``, with
    ``snapshot_pages`` and ``migration_prefix_hint`` for the disaggregated
    handoff) ships a decoding slot's live pages as stored, int8 pools as
    their values and scales, and restores them token-exactly on another
    server, mapping pages its prefix cache already holds read-only.

    The attention of every leg goes through the paged-attention kernels on
    the card and through their plain version on the CPU; there is no
    switch. ``overlap=True`` double-buffers the host loop
    (``SlotServerBase``): the decode step queues without a host sync, its
    dropped writes going to the drop page. ``device`` defaults to the card
    and raises without CUDA; *params* must already live on it.

    Multi-tenant LoRA serving is the subclass
    ``multi_lora.PagedMultiLoraDecodeServer``. ``declare_slos`` and
    ``enable_profiler`` are the base's.

    ``mesh=`` (dp and tp axes; ``SlotServerBase``): the parameters are cut
    by ``train.param_specs`` and the pool holds the rank's ``H_kv/tp``
    heads, replicated over dp with the page axis whole, so every rank runs
    every slot and the host scheduler alike. ``snapshot_slot``,
    ``snapshot_pages`` and ``export_prefix_span`` gather the heads over tp
    (the one-card layout); ``restore_slot`` and ``inject_prefix`` keep
    each rank's heads of it; every rank must make each of these calls.
    ``check_invariants`` also compares every rank's table, free list and
    scheduler state (``check_lockstep``)."""

    # the two device legs, called through the instance so that
    # ``enable_profiler`` can watch them (the JAX server's ``_prefill_chunk``
    # and ``_step_all``)
    _prefill_leg = staticmethod(forward_chunk_io)
    _step_leg = staticmethod(paged_forward_one)

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 n_slots: int = 8, max_seq: int = 512,
                 max_new_tokens: int = 64, page_size: int = 16,
                 n_pages: Optional[int] = None, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 kv_int8: bool = False, prefill_budget: int = 0,
                 overlap: bool = False, queue_ttl: Optional[float] = None,
                 prefix_cache_pages: int = 0, pool_frac: float = 1.0,
                 host_tier_bytes: int = 0, device=None, mesh=None) -> None:
        device = resolve_device(device)
        if not 0.0 < pool_frac <= 1.0:
            raise ValueError("pool_frac must be in (0, 1]")
        if prefix_cache_pages < 0:
            raise ValueError("prefix_cache_pages must be >= 0 (0 = off)")
        if host_tier_bytes < 0:
            raise ValueError("host_tier_bytes must be >= 0 (0 = off)")
        if host_tier_bytes and not prefix_cache_pages:
            raise ValueError(
                "host_tier_bytes needs prefix_cache_pages > 0 — the host "
                "tier spills FROM the HBM prefix tree")
        if prefix_cache_pages and cfg.window > 0:
            raise ValueError(
                "prefix_cache_pages is incompatible with windowed serving: "
                "the ring table aliases logical pages onto a per-slot "
                "physical ring, which cannot be shared across slots")
        for p in params.state_dict().values():   # int8 buffers too
            if p.device.type != device.type:
                raise ValueError(f"params live on {p.device}, the server "
                                 f"on {device}")
        super().__init__(cfg, params, n_slots, max_seq, max_new_tokens,
                         eos_id, temperature=temperature, top_k=top_k,
                         top_p=top_p, seed=seed,
                         prefill_budget=prefill_budget, overlap=overlap,
                         queue_ttl=queue_ttl, device=device, mesh=mesh)
        self.page_size = page_size
        self._min_bucket = page_size
        # _seq_margin(): positions past max_seq a slot's table must cover
        # (the speculative server's verify chunk overshoots by gamma_max)
        self.max_pages_per_slot = (
            max_seq + self._seq_margin() + page_size - 1) // page_size
        self._ring_pages = (self._pages_needed(cfg.window) + 1
                            if cfg.window > 0 else 0)
        self.pool_frac = float(pool_frac)
        base_pages = n_pages or (n_slots * self.max_pages_per_slot + 1) // 2
        self.pool_pages = max(1, int(base_pages * self.pool_frac))
        self.kv_int8 = kv_int8
        # the stores hold the drop page past the addressable pool
        tp = col.axis_size(mesh, "tp")
        self._tp_group = None if mesh is None else self._groups.over("tp")
        self._heads = (col.axis_index(mesh, "tp") * (cfg.kv_heads // tp),
                       (col.axis_index(mesh, "tp") + 1) * (cfg.kv_heads // tp))
        self._k_store, self._v_store = init_page_pool(
            cfg, self.pool_pages + 1, page_size, kv_int8=kv_int8,
            device=device, tp=tp)
        self.k_pages = _pool_view(self._k_store, self.pool_pages)
        self.v_pages = _pool_view(self._v_store, self.pool_pages)
        self._free: List[int] = list(range(self.pool_pages))
        self._table = np.full((n_slots, self.max_pages_per_slot), -1,
                              np.int32)
        self._table_dev: Optional[torch.Tensor] = None   # device mirror
        self._sampler = make_slot_sampler()
        self._attend = partial(paged_attention, window=cfg.window)
        # windowed chunks keep the gather-before-write order of the gather
        # path: the chunk kernel writes first, which a ring cannot afford
        self._attend_chunk = paged_attention_chunk if cfg.window == 0 else None
        self.obs.gauge_fn("kubetpu_serving_pool_pages",
                          lambda: self.pool_pages)
        self.obs.gauge_fn("kubetpu_serving_pages_in_use",
                          lambda: self.pages_in_use())
        self.obs.gauge_fn("kubetpu_serving_pages_free",
                          lambda: len(self._free))
        self.obs.gauge_fn("kubetpu_serving_pool_frac",
                          lambda: self.pool_frac)
        # shared-prefix reuse: per slot, how many leading table rows are
        # shared (read-only) mappings, the pinned deepest-match node, and
        # the prompt to publish at retirement
        self.prefix_cache_pages = int(prefix_cache_pages)
        self.host_tier_bytes = int(host_tier_bytes)
        self._prefix_cache = (
            RadixPrefixCache(page_size, self.prefix_cache_pages,
                             host_budget_bytes=self.host_tier_bytes)
            if self.prefix_cache_pages else None)
        self._slot_shared = [0] * n_slots
        self._slot_pin = [None] * n_slots
        self._slot_prompt: List[Optional[List[int]]] = [None] * n_slots
        # (matched, start, host tokens) of the slot's last _prefill_start,
        # committed to the reuse counters when the admission completes
        self._slot_pending_stats: List[Optional[Tuple[int, int, int]]] = (
            [None] * n_slots)
        if self._prefix_cache is not None:
            self._c_hit_tokens = self.obs.counter(
                "kubetpu_prefix_hit_tokens_total",
                "full-page prefix tokens found cached at admission")
            self._c_saved_tokens = self.obs.counter(
                "kubetpu_prefill_tokens_saved_total",
                "prompt tokens whose prefill was skipped via mapped "
                "shared pages")
            self._c_req_hit = self.obs.counter(
                "kubetpu_prefix_requests_total", result="hit")
            self._c_req_miss = self.obs.counter(
                "kubetpu_prefix_requests_total", result="miss")
            self._c_evicted = self.obs.counter(
                "kubetpu_prefix_evicted_pages_total")
            self._c_inserted = self.obs.counter(
                "kubetpu_prefix_inserted_pages_total")
            self.obs.gauge_fn("kubetpu_prefix_tree_pages",
                              lambda: self._prefix_cache.total_pages)
            self.obs.gauge_fn("kubetpu_prefix_tree_nodes",
                              lambda: self._prefix_cache.n_nodes())
            # per tier: pages hit at admission, pages filled back into the
            # pool, pages spilled out of it, bytes moved across each tier
            # boundary, and prefill tokens saved
            self._c_tier_hits = {
                t: self.obs.counter("kubetpu_prefix_tier_hits_total",
                                    tier=t)
                for t in ("hbm", "host", "peer")}
            self._c_tier_fills = {
                t: self.obs.counter("kubetpu_prefix_tier_fills_total",
                                    tier=t)
                for t in ("host", "peer")}
            self._c_tier_spills = {
                "host": self.obs.counter(
                    "kubetpu_prefix_tier_spills_total", tier="host")}
            self._c_tier_bytes = {
                t: self.obs.counter("kubetpu_prefix_tier_bytes_total",
                                    tier=t)
                for t in ("hbm", "host", "peer")}
            self._c_tier_saved = {
                t: self.obs.counter(
                    "kubetpu_prefix_tier_tokens_saved_total", tier=t)
                for t in ("hbm", "host", "peer")}
            self.obs.gauge_fn("kubetpu_prefix_host_bytes",
                              lambda: self._prefix_cache.host_bytes)
            self.obs.gauge_fn("kubetpu_prefix_host_nodes",
                              lambda: len(self._prefix_cache.host_nodes()))

    # -- page accounting -----------------------------------------------------

    def pages_in_use(self) -> int:
        return self.pool_pages - len(self._free)

    def _pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def _seq_margin(self) -> int:
        """Positions past ``max_seq`` every slot's reservation and the
        table width must also cover: 0 for one-token decode (the
        speculative server returns ``gamma_max``)."""
        return 0

    def _worst_case_tokens(self, prompt_len: int) -> int:
        return prompt_len + self.max_new_tokens + 1 + self._seq_margin()

    def _alloc_pages(self, slot: int, upto_tokens: int) -> bool:
        """Map pages so *slot* can hold *upto_tokens* tokens; False (nothing
        mapped) when the pool cannot cover them. A windowed slot maps its
        physical ring once and aliases every logical page onto it. With a
        prefix cache, pool pressure first reclaims evictable tree pages;
        shared rows already mapped count toward ``have``."""
        need = self._pages_needed(upto_tokens)
        if self._ring_pages:
            if (self._table[slot] >= 0).any():
                return True        # the ring already covers every page
            phys_need = min(need, self._ring_pages)
            if phys_need > len(self._free):
                return False
            ring = [self._free.pop() for _ in range(phys_need)]
            for lp in range(need):
                self._table[slot, lp] = ring[lp % phys_need]
            self._table_dev = None
            return True
        have = int((self._table[slot] >= 0).sum())
        short = (need - have) - len(self._free)
        if short > 0 and self._prefix_cache is not None:
            self._tree_reclaim(short, reason="pool_pressure")
        if need - have > len(self._free):
            return False
        if need > have:
            for lp in range(have, need):
                self._table[slot, lp] = self._free.pop()
            self._table_dev = None
        return True

    def _release_pages(self, slot: int, keep=()) -> None:
        """Unmap the slot's table; slot-owned pages return to the free list,
        each physical page once (a ring aliases them). The leading shared
        rows are tree property and *keep* pages were just donated to the
        tree: cleared from the table, never freed here."""
        shared = self._slot_shared[slot]
        freed = set()
        for lp in range(self.max_pages_per_slot):
            phys = int(self._table[slot, lp])
            if (phys >= 0 and phys not in freed and lp >= shared
                    and phys not in keep):
                self._free.append(phys)
                freed.add(phys)
            self._table[slot, lp] = -1
        self._slot_shared[slot] = 0
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
        if self._ring_pages:
            need = min(need, self._ring_pages)
        if need > self.pool_pages:
            raise ValueError(
                f"request needs {need} pages worst-case but the pool has "
                f"only {self.pool_pages} — raise n_pages or lower "
                f"max_new_tokens")

    def _note_admitted(self, slot: int, prompt: List[int]) -> None:
        # the prompt is published at retirement, and only once its prefill
        # completed (a parked prefill's half-written pages never are); the
        # reuse counters commit once per completed admission, not per try
        self._slot_prompt[slot] = list(prompt)
        pending = self._slot_pending_stats[slot]
        if pending is not None:
            matched, start, host_tokens = pending
            if start > 0:
                self._c_req_hit.inc()
                self._c_hit_tokens.inc(matched)
                self._c_saved_tokens.inc(start)
                # tokens promoted from the host tier during this admission
                # are host-tier savings; the rest was already in HBM
                ps = self.page_size
                self._c_tier_hits["host"].inc(host_tokens // ps)
                self._c_tier_saved["host"].inc(host_tokens)
                self._c_tier_hits["hbm"].inc((start - host_tokens) // ps)
                self._c_tier_saved["hbm"].inc(start - host_tokens)
            else:
                self._c_req_miss.inc()
            self._slot_pending_stats[slot] = None

    def _on_retire(self, slot: int) -> None:
        published = self._publish_prefix(slot)
        self._release_pages(slot, keep=published)
        if self._slot_pin[slot] is not None:
            self._prefix_cache.release(self._slot_pin[slot])
            self._slot_pin[slot] = None
        self._slot_prompt[slot] = None
        self._slot_pending_stats[slot] = None   # parked prefill: no commit

    # -- shared-prefix reuse -------------------------------------------------

    def _prefill_start(self, prompt: List[int], slot: int) -> int:
        """Match the longest cached full-page prefix (host-tier spans are
        filled back first), map its pages read-only as the slot's leading
        table rows, pin the deepest matched node for the slot's lifetime,
        and return where prefill starts. The match is capped one token
        short of the prompt: the last token's page is recomputed into a
        private page, never written into a shared one (the COW rule)."""
        if self._prefix_cache is None:
            return 0
        ps = self.page_size
        host_tokens = self._fill_host_prefix(prompt)
        matched, pages, node = self._prefix_cache.match(prompt)
        start = min(matched, ((len(prompt) - 1) // ps) * ps)
        if start <= 0:
            self._slot_pending_stats[slot] = (matched, 0, 0)
            return 0
        use = start // ps
        self._table[slot, :use] = np.asarray(pages[:use], np.int32)
        self._table_dev = None
        self._slot_shared[slot] = use
        self._prefix_cache.pin(node)
        self._slot_pin[slot] = node
        self._slot_pending_stats[slot] = (matched, start,
                                          min(host_tokens, start))
        self.events.emit("prefix_hit", slot=slot, matched_tokens=matched,
                         prefill_start=start, pages=use,
                         host_filled_tokens=min(host_tokens, start))
        return start

    def _prefix_unmap(self, slot: int) -> None:
        """Roll back a ``_prefill_start`` mapping after a failed monolithic
        admission: the request returns to the queue, the slot reads as
        empty."""
        self._release_pages(slot)   # shared rows cleared, nothing freed
        if self._slot_pin[slot] is not None:
            self._prefix_cache.release(self._slot_pin[slot])
            self._slot_pin[slot] = None
        self._slot_pending_stats[slot] = None

    def _publish_prefix(self, slot: int):
        """Donate the retiring slot's full prompt pages to the tree (they
        already hold the prompt's KV: host bookkeeping only), evicting LRU
        branches to make budget room. Returns the donated pages."""
        prompt = self._slot_prompt[slot]
        if self._prefix_cache is None or not prompt:
            return ()
        ps = self.page_size
        full = len(prompt) // ps
        if full <= 0:
            return ()
        tokens = prompt[:full * ps]
        pages = [int(self._table[slot, j]) for j in range(full)]
        if any(p < 0 for p in pages):   # defensive: never publish holes
            return ()
        tree = self._prefix_cache
        need = tree.missing_pages(tokens)
        over = tree.total_pages + need - tree.max_pages
        if over > 0:
            self._tree_reclaim(over, reason="budget")
        consumed = tree.insert(tokens, pages)
        if consumed:
            self._c_inserted.inc(len(consumed))
            self.events.emit("prefix_publish", slot=slot,
                             pages=len(consumed))
        return consumed

    # -- tiered KV cache: HBM -> host DRAM -> peer replicas ------------------

    def _tree_reclaim(self, n_pages: int, reason: str) -> List[int]:
        """Evict >= *n_pages* from the tree into the free list. With the
        host tier on, victims spill: their stored-layout KV is copied to
        host buffers before the pages free. A barrier leg off the decode
        step: the spill copy is its designed device->host sync."""
        tree = self._prefix_cache
        gather = None
        if self.host_tier_bytes > 0:
            def gather(phys):
                payload = self._gather_phys_pages(phys)
                self._c_tier_bytes["host"].inc(
                    sum(a.nbytes for a in payload.values()))
                return payload
        before = tree.spilled_pages
        reclaimed = tree.evict(n_pages, gather=gather)
        spilled = tree.spilled_pages - before
        if spilled:
            self._c_tier_spills["host"].inc(spilled)
            self.events.emit("prefix_spill", pages=spilled, reason=reason)
        if reclaimed:
            self._free.extend(reclaimed)
            self._c_evicted.inc(len(reclaimed))
            self.events.emit("prefix_evict", pages=len(reclaimed),
                             reason=reason)
        return reclaimed

    def _fill_host_prefix(self, prompt: List[int]) -> int:
        """Promote host-tier spans covering *prompt* back into the pool,
        top-down along the match path, so the HBM match that follows sees
        them. Best effort: a span that gets no room stays host and the
        match stops shorter. Returns the tokens promoted now."""
        tree = self._prefix_cache
        if tree is None or self.host_tier_bytes <= 0:
            return 0
        _, segs = tree.match_tiered(prompt)
        filled_tokens = 0
        for node, _jp in segs:
            if node.host is None:
                continue
            if not self._fill_host_node(node):
                break
            filled_tokens += len(node.tokens)
        return filled_tokens

    def _fill_host_node(self, node) -> bool:
        """Fill one host-tier node back into the pool: make tree budget and
        pool room (reclaiming evictable tree pages first), pop pages,
        upload the host buffers and commit with ``tree.promote``. The node
        is pinned across the reclaim so it cannot be dropped from under the
        path being rebuilt. False = no room; the node stays host."""
        tree = self._prefix_cache
        n = len(node.tokens) // self.page_size
        tree.pin(node)
        try:
            over = tree.total_pages + n - tree.max_pages
            if over > 0:
                self._tree_reclaim(over, reason="fill_budget")
            if tree.total_pages + n > tree.max_pages:
                return False
            if n > len(self._free):
                self._tree_reclaim(n - len(self._free),
                                   reason="fill_pressure")
            if n > len(self._free):
                return False
            nbytes = sum(a.nbytes for a in node.host.values())
            phys = [self._free.pop() for _ in range(n)]
            self._upload_host_pages(node.host, phys)
            tree.promote(node, phys)
            self._c_tier_fills["host"].inc(n)
            self._c_tier_bytes["host"].inc(nbytes)
            self.events.emit("prefix_fill", tier="host", pages=n)
            return True
        finally:
            tree.release(node)

    def _page_field_names(self) -> Tuple[str, ...]:
        return (("k_q", "k_s", "v_q", "v_s") if self.kv_int8
                else ("k", "v"))

    def _pool_fields(self):
        """(pool tensor, field name) pairs in ``_page_field_names`` order."""
        pools = ((self.k_pages, ("k_q", "k_s") if self.kv_int8 else ("k",)),
                 (self.v_pages, ("v_q", "v_s") if self.kv_int8 else ("v",)))
        for pool, names in pools:
            yield from zip(pool if isinstance(pool, tuple) else (pool,),
                           names)

    def _whole_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A CPU copy of stored-layout pages (heads on axis 3) with every
        tp rank's heads: gathered over tp (through host tensors under
        gloo, which takes every stored dtype there), as they are on one
        card."""
        if self._tp_group is None:
            return t.cpu()
        dev = ("cpu" if dist.get_backend(self._tp_group) == "gloo"
               else self.device)
        return col.all_gather(t.to(dev), self._tp_group, "tp_pages",
                              dim=3).cpu()

    def _gather_phys_pages(self, phys_list, whole: bool = False) -> dict:
        """CPU copies of physical pool pages in their stored dtype and
        layout (page axis 1; int8 pools as the quantized values and scales,
        never dequantized): the spill's and the export's one designed
        device->host sync. *whole*: every tp rank's heads
        (``_whole_heads``), else this rank's."""
        phys = torch.as_tensor(np.asarray(phys_list, np.int64),
                               device=self.device)
        out = {name: pool[:, phys] for pool, name in self._pool_fields()}
        return {name: self._whole_heads(t) if whole else t.cpu()
                for name, t in out.items()}

    def _upload_host_pages(self, pages: dict, phys_list,
                           whole: bool = False) -> None:
        """Write a stored-layout page dict of CPU tensors into the pool at
        physical pages *phys_list*: the fill's and the inject's designed
        host->device copy. *whole*: the dict holds every tp rank's heads,
        of which this rank keeps its own."""
        phys = torch.as_tensor(np.asarray(phys_list, np.int64),
                               device=self.device)
        h0, h1 = self._heads
        for pool, name in self._pool_fields():
            arr = pages[name]
            if whole and self._tp_group is not None:
                arr = arr[:, :, :, h0:h1]
            pool[:, phys] = arr.to(self.device, pool.dtype)

    def prefix_local_pages(self, prompt: List[int]) -> int:
        """Full pages of *prompt* this server covers across both local
        tiers (HBM + host): the replica's peer-fetch gate. Host
        bookkeeping only."""
        if self._prefix_cache is None or not prompt:
            return 0
        matched, _segs = self._prefix_cache.match_tiered(prompt)
        return matched // self.page_size

    def export_prefix_span(self, prompt: List[int],
                           from_page: int = 0) -> Optional[dict]:
        """This server's cached coverage of *prompt* for a peer replica:
        ``{matched_tokens, from_page, n_pages, pages}`` with ``pages`` the
        arrays of logical pages ``[from_page, n_pages)`` in the stored
        layout (page axis 1; numpy, bf16 as tensors), or None when coverage does not reach
        past *from_page*. Host-tier spans ship from their buffers, HBM
        spans pay the gather. Read-only (LRU stamps aside)."""
        if self._prefix_cache is None or not prompt or from_page < 0:
            return None
        matched, segs = self._prefix_cache.match_tiered(prompt)
        n_pages = matched // self.page_size
        if n_pages <= from_page:
            return None
        parts = []
        for node, jp in segs:
            if node.host is not None:
                parts.append({k: v[:, :jp] for k, v in node.host.items()})
            else:
                parts.append(self._gather_phys_pages(node.pages[:jp]))
        out = {name: _host_array(self._whole_heads(torch.cat(
            [_cpu_tensor(p[name]) for p in parts], dim=1)[:, from_page:n_pages]
            .contiguous()))
            for name in self._page_field_names()}
        self._c_tier_bytes["peer"].inc(
            sum(a.nbytes for a in out.values()))
        self.events.emit("prefix_export", pages=n_pages - from_page,
                         from_page=from_page)
        return {
            "matched_tokens": n_pages * self.page_size,
            "from_page": int(from_page),
            "n_pages": int(n_pages),
            "pages": out,
        }

    def inject_prefix(self, tokens: List[int], pages: dict,
                      from_page: int = 0) -> int:
        """Adopt a peer-fetched span (stored layout, logical pages
        ``[from_page, n)`` of *tokens*) into the local tree: make tree
        budget and pool room, upload the uncovered pages and insert. Local
        coverage that receded below *from_page* leaves a hole: refused
        (returns 0; the caller prefills cold). Idempotent: spans the tree
        already covers consume nothing. Returns pages adopted."""
        tree = self._prefix_cache
        if tree is None or not tokens or from_page < 0:
            return 0
        ps = self.page_size
        n = len(tokens) // ps
        if n <= from_page:
            return 0
        tokens = [int(t) for t in tokens[:n * ps]]
        for name in self._page_field_names():
            arr = pages.get(name)
            if arr is None or arr.shape[1] != n - from_page:
                raise ValueError(
                    f"injected span field {name!r} covers "
                    f"{None if arr is None else arr.shape[1]} pages, "
                    f"want {n - from_page}")
        # promote local host-tier coverage first: insert adopts host nodes
        # by consuming donated pages, and a donated page below from_page
        # carries no peer bytes
        self._fill_host_prefix(tokens)
        hbm_cov = tree.match(tokens)[0] // ps
        if hbm_cov < from_page:
            return 0            # coverage receded under the fetch: hole
        need = tree.missing_pages(tokens)
        if need <= 0:
            return 0
        over = tree.total_pages + need - tree.max_pages
        if over > 0:
            self._tree_reclaim(over, reason="inject_budget")
        if tree.total_pages + need > tree.max_pages:
            return 0
        if need > len(self._free):
            self._tree_reclaim(need - len(self._free),
                               reason="inject_pressure")
        if need > len(self._free):
            return 0
        # donate real pool pages only past the local HBM coverage; upload
        # those columns, insert, free whatever was not consumed
        alloc = [self._free.pop() for _ in range(n - hbm_cov)]
        col0 = hbm_cov - from_page
        if alloc:
            self._upload_host_pages(
                {name: _cpu_tensor(arr[:, col0:])
                 for name, arr in pages.items()}, alloc, whole=True)
        donated = [-1] * hbm_cov + alloc
        consumed = tree.insert(tokens, donated)
        assert all(p >= 0 for p in consumed), \
            "inject consumed a placeholder page"
        for p in alloc:
            if p not in consumed:
                self._free.append(p)
        if consumed:
            self._c_inserted.inc(len(consumed))
            self._c_tier_hits["peer"].inc(len(consumed))
            self._c_tier_fills["peer"].inc(len(consumed))
            self._c_tier_saved["peer"].inc(len(consumed) * ps)
            self._c_tier_bytes["peer"].inc(sum(
                arr[:, col0:].nbytes for arr in pages.values()))
            self.events.emit("prefix_inject", pages=len(consumed),
                             from_page=int(from_page))
        return len(consumed)

    def tier_stats(self) -> dict:
        """Per-tier reuse stats: pages hit / filled / spilled, bytes moved,
        tokens saved per tier, and host-tier occupancy (the
        ``kubetpu_prefix_tier_*`` series as a dict). Host counters only."""
        if self._prefix_cache is None:
            return {"enabled": False}
        tree = self._prefix_cache
        return {
            "enabled": True,
            "host_tier_bytes": self.host_tier_bytes,
            "host_bytes": tree.host_bytes,
            "host_nodes": len(tree.host_nodes()),
            "spilled_pages": tree.spilled_pages,
            "hits": {t: int(c.value)
                     for t, c in self._c_tier_hits.items()},
            "fills": {t: int(c.value)
                      for t, c in self._c_tier_fills.items()},
            "spills": {t: int(c.value)
                       for t, c in self._c_tier_spills.items()},
            "bytes": {t: int(c.value)
                      for t, c in self._c_tier_bytes.items()},
            "tokens_saved": {t: int(c.value)
                             for t, c in self._c_tier_saved.items()},
        }

    def prefix_cache_stats(self) -> dict:
        """Host-side reuse stats: requests hit/miss, hit rate, tokens
        matched/saved, tree pages/nodes, evicted and inserted pages, host
        tier occupancy — the ``kubetpu_prefix_*`` series as a dict."""
        if self._prefix_cache is None:
            return {"enabled": False}
        hits = int(self._c_req_hit.value)
        misses = int(self._c_req_miss.value)
        total = hits + misses
        return {
            "enabled": True,
            "requests_hit": hits,
            "requests_miss": misses,
            "hit_rate": (hits / total) if total else 0.0,
            "hit_tokens": int(self._c_hit_tokens.value),
            "prefill_tokens_saved": int(self._c_saved_tokens.value),
            "tree_pages": self._prefix_cache.total_pages,
            "tree_nodes": self._prefix_cache.n_nodes(),
            "evicted_pages": int(self._c_evicted.value),
            "inserted_pages": int(self._c_inserted.value),
            "host_bytes": self._prefix_cache.host_bytes,
            "host_nodes": len(self._prefix_cache.host_nodes()),
            "spilled_pages": self._prefix_cache.spilled_pages,
        }

    def load_info(self) -> dict:
        """The base snapshot plus the pool's pressure signals and, with the
        prefix cache on, its hit rate, tree size and tier counters. Host
        counters only."""
        info = super().load_info()
        info["pool_pages"] = self.pool_pages
        info["pages_free"] = len(self._free)
        info["pages_in_use"] = self.pages_in_use()
        if self.pool_frac < 1.0:
            info["pool_frac"] = self.pool_frac
        if self._prefix_cache is not None:
            stats = self.prefix_cache_stats()
            info["prefix_hit_rate"] = stats["hit_rate"]
            info["prefix_tree_pages"] = stats["tree_pages"]
            if self.host_tier_bytes > 0:
                tier = self.tier_stats()
                info["tier_host_bytes"] = tier["host_bytes"]
                info["tier_host_nodes"] = tier["host_nodes"]
                info["tier_hits"] = tier["hits"]
                info["tier_fills"] = tier["fills"]
                info["tier_spills"] = tier["spills"]
        return info

    def check_invariants(self) -> None:
        """The pool accounting oracle: every physical page is owned by
        exactly one of {the free list, one slot's private mapping, the
        prefix tree}; a ring slot maps each of its pages many times, shared
        rows point only at tree-owned pages, a slot holding pages is
        decoding or mid-prefill, node refcounts equal the live pins, and
        the tree's own structure checks out. AssertionError on a
        violation."""
        free = list(self._free)
        free_set = set(free)
        assert len(free) == len(free_set), "free list holds a page twice"
        assert free_set <= set(range(self.pool_pages)), \
            "free list holds an out-of-range page"
        tree_pages = (self._prefix_cache.owned_pages()
                      if self._prefix_cache is not None else set())
        assert not (free_set & tree_pages), "page both free and tree-owned"
        slot_owned = set()
        for slot in range(self.n_slots):
            shared = self._slot_shared[slot]
            row = [int(p) for p in self._table[slot] if p >= 0]
            if row:
                assert (self.active[slot] or slot in self._prefills
                        or slot in self._frozen), \
                    f"idle slot {slot} still maps pages {row}"
            private = set()
            for lp in range(self.max_pages_per_slot):
                phys = int(self._table[slot, lp])
                if phys < 0:
                    continue
                if lp < shared:
                    assert phys in tree_pages, (
                        f"slot {slot} shared row {lp} -> page {phys} "
                        f"not tree-owned")
                    continue
                if phys in private:
                    assert self._ring_pages, \
                        f"slot {slot} maps page {phys} twice off a ring"
                    continue
                assert phys not in slot_owned, \
                    f"page {phys} mapped privately by two slots"
                assert phys not in tree_pages, (
                    f"slot {slot} private row {lp} -> tree-owned page "
                    f"{phys}")
                assert phys not in free_set, \
                    f"page {phys} both mapped and free"
                private.add(phys)
            if self._ring_pages:
                assert len(private) <= self._ring_pages, (
                    f"slot {slot} maps {len(private)} pages, its ring is "
                    f"{self._ring_pages}")
            slot_owned |= private
        assert len(free_set) + len(slot_owned) + len(tree_pages) \
            == self.pool_pages, (
                f"pages leaked or double-owned: free {len(free_set)} + "
                f"slots {len(slot_owned)} + tree {len(tree_pages)} != "
                f"pool {self.pool_pages}")
        if self._prefix_cache is not None:
            self._prefix_cache.check()
            pins: dict = {}
            for slot in range(self.n_slots):
                node = self._slot_pin[slot]
                if node is not None:
                    pins[id(node)] = pins.get(id(node), 0) + 1
                    assert self._slot_shared[slot] > 0, (
                        f"slot {slot} pins a node but maps no shared "
                        f"pages")
                else:
                    assert self._slot_shared[slot] == 0, (
                        f"slot {slot} maps shared pages without a pin")
            for node in self._prefix_cache.nodes():
                assert node.refcount == pins.get(id(node), 0), (
                    f"node refcount {node.refcount} != "
                    f"{pins.get(id(node), 0)} live pins")
        self.check_lockstep()

    def _host_state(self) -> list:
        return super()._host_state() + [self._table.tolist(),
                                        list(self._free)]

    # -- live KV migration ---------------------------------------------------

    def _migration_kind(self) -> str:
        """Compatibility tag a snapshot carries; restore refuses a mismatch
        (a plain paged snapshot must not land on a speculative server whose
        table width includes the gamma margin)."""
        return "paged"

    def _gather_page_span(self, slot: int, from_page: int,
                          to_page: int) -> dict:
        """Host copies of the slot's logical pages ``[from_page, to_page)``
        gathered through the table, in their stored layout (dense: k/v;
        kv_int8: the k_q/k_s/v_q/v_s quadruple, never dequantized) and
        travelling form (``_host_array``): the one designed device->host
        sync a handoff span pays."""
        row = self._table[slot, from_page:to_page]
        assert (row >= 0).all(), "live pages unmapped under a gather"
        return {name: _host_array(t) for name, t in
                self._gather_phys_pages(row, whole=True).items()}

    def snapshot_pages(self, rid: int, from_page: int,
                       to_page: int) -> dict:
        """Gather a completed page span of *rid*'s slot: the disaggregated
        handoff's streaming leg. Page-aligned chunk starts make every full
        page below ``prefill_progress`` final, so a prefill replica ships
        spans while later chunks still compute. Valid for mid-prefill and
        decoding slots; the caller ships only pages below the progress mark
        or the decode position's page. A barrier leg."""
        if self._ring_pages:
            raise NotImplementedError(
                "windowed (ring) slots have no shippable logical page "
                "view")
        if not 0 <= from_page < to_page:
            raise ValueError(f"bad page span [{from_page}, {to_page})")
        try:
            slot = self._slot_rid.index(rid)
        except ValueError:
            raise ValueError(f"request {rid} holds no slot") from None
        return self._gather_page_span(slot, from_page, to_page)

    def snapshot_slot(self, rid: int, from_page: int = 0,
                      allow_frozen: bool = False) -> dict:
        """Everything needed to resume *rid* token-exactly on another
        replica: the request state (``_snapshot_request``, the raw request
        key included, so seeded sampling continues identically) and the
        slot's live pages gathered through the table, as stored (int8
        pools ship values and scales: the restored pool is bit-identical).
        Only pages holding live tokens ship (positions 0..pos; decode
        rewrites position pos before any read). *from_page* skips pages
        the caller already shipped (the streaming handoff gathers only the
        tail); ``n_live_pages`` stays absolute. *allow_frozen* lets the
        handoff owner snapshot a slot it froze itself; third parties keep
        getting the refusal, or two racing policies would ship one epoch
        to two targets.

        Refused (ValueError) for queued, mid-chunked-prefill,
        deferred-first-token and already-frozen streams; windowed (ring)
        servers raise NotImplementedError: a ring aliases logical pages per
        slot. A barrier leg: the device gather is its designed sync."""
        if self._ring_pages:
            raise NotImplementedError(
                "windowed (ring) slots cannot migrate: the ring aliases "
                "logical pages per slot; there is no shippable logical "
                "page view")
        if self._inflight is not None:
            raise ValueError(
                "snapshot requires the overlap pipeline flushed — an "
                "unrouted step may still move this stream")
        if any(qrid == rid for qrid, _p, _d in self._queue):
            raise ValueError(f"request {rid} is still queued — nothing "
                             f"to migrate; route the prompt instead")
        try:
            slot = self._slot_rid.index(rid)
        except ValueError:
            raise ValueError(f"request {rid} holds no slot") from None
        if slot in self._prefills:
            raise ValueError(
                f"request {rid} is mid-chunked-prefill — migration "
                f"only between rounds (let the admission finish)")
        if slot in self._pending_first:
            raise ValueError(
                f"request {rid}'s first token is still deferred — "
                f"step once before migrating")
        if slot in self._frozen and not allow_frozen:
            raise ValueError(
                f"request {rid} is already frozen for another handoff")
        if not self.active[slot] and slot not in self._frozen:
            raise ValueError(f"request {rid} is not decoding")
        snap = self._snapshot_request(rid, slot)
        # tokens stored: the prompt and every emitted token but the last,
        # whose K/V the next step writes at pos (pos + 1 in all)
        n_live = self._pages_needed(int(self.pos[slot]) + 1)
        if not 0 <= from_page <= n_live:
            raise ValueError(
                f"from_page {from_page} outside the live span "
                f"[0, {n_live}]")
        pages = self._gather_page_span(slot, from_page, n_live)
        snap.update({
            "kind": self._migration_kind(),
            "cfg_fp": reference_config_repr(self.cfg),
            "page_size": self.page_size,
            "kv_int8": bool(self.kv_int8),
            "max_seq": self.max_seq,
            "n_live_pages": int(n_live),
            "pages": pages,
        })
        self.events.emit("snapshot", rid=rid, slot=slot, pages=int(n_live))
        return snap

    def migration_prefix_hint(self, prompt: List[int]) -> int:
        """Full pages of *prompt* this server could map read-only from its
        prefix cache now: the ``/migrate_in`` begin phase advertises it, so
        the source ships only the uncached suffix. A hint, never a
        promise: ``restore_slot`` refuses a match that receded since.
        Host-tier coverage counts (the restore's ``_prefill_start`` fills
        it first)."""
        if self._prefix_cache is None or not prompt:
            return 0
        matched, _segs = self._prefix_cache.match_tiered(prompt)
        start = min(matched, ((len(prompt) - 1) // self.page_size)
                    * self.page_size)
        return max(0, start // self.page_size)

    def restore_slot(self, snap: dict, reason: str = "migrate"):
        """Rebuild a snapshot stream into a free slot and resume decode ->
        the new local rid, or None when no slot or not enough pool pages
        are free (nothing mutated; the caller may retry another replica).
        Pages this server's prefix cache holds map read-only instead of
        taking shipped bytes, so ``pages`` may start at logical page
        ``ship_from_page`` (the begin-phase hint the source honored) and
        only the uncached suffix uploads. A match that receded below the
        shipped offset refuses (ValueError) rather than restore with
        holes. The config must be the source's (``cfg_fp`` in the JAX
        package's form, page size, kv_int8, max_seq, max_new_tokens,
        eos_id). A barrier leg: the page upload is its designed
        host->device copy."""
        if self._ring_pages:
            raise NotImplementedError(
                "windowed (ring) servers cannot accept migrated slots")
        if snap.get("kind") != self._migration_kind():
            raise ValueError(
                f"snapshot kind {snap.get('kind')!r} does not match this "
                f"server ({self._migration_kind()!r})")
        for field, mine in (("cfg_fp", reference_config_repr(self.cfg)),
                            ("page_size", self.page_size),
                            ("kv_int8", bool(self.kv_int8)),
                            ("max_seq", self.max_seq),
                            ("max_new_tokens", self.max_new_tokens),
                            ("eos_id", self.eos_id)):
            if snap.get(field) != mine:
                raise ValueError(
                    f"snapshot {field}={snap.get(field)!r} does not match "
                    f"this server's {mine!r} — migration requires "
                    f"config-identical replicas")
        prompt = [int(t) for t in snap["prompt"]]
        emitted = [int(t) for t in snap["emitted"]]
        if not emitted:
            raise ValueError("snapshot carries no emitted tokens — the "
                             "stream never started decoding")
        if len(emitted) >= self.max_new_tokens or (
                self.eos_id is not None and emitted[-1] == self.eos_id):
            raise ValueError("snapshot stream is already finished")
        free = self._free_slots()
        if not free:
            return None
        slot = free[0]
        # cached prefix pages map read-only (never copied: the bytes are
        # already here); the uncached suffix uploads from the snapshot
        ship_from = int(snap.get("ship_from_page", 0))
        start = self._prefill_start(prompt, slot)
        use = start // self.page_size if start else 0
        if use < ship_from:
            self._prefix_unmap(slot)
            raise ValueError(
                f"prefix receded: snapshot pages start at logical page "
                f"{ship_from} but only {use} pages matched locally — "
                f"re-ship with a fresh hint")
        if not self._alloc_pages(slot, self._worst_case_tokens(len(prompt))):
            self._prefix_unmap(slot)
            return None
        n_live = int(snap["n_live_pages"])
        for name, arr in snap.get("pages", {}).items():
            if arr.shape[1] != n_live - ship_from:
                self._prefix_unmap(slot)     # frees the private rows too
                raise ValueError(
                    f"snapshot page array {name!r} holds {arr.shape[1]} "
                    f"pages, want {n_live - ship_from} "
                    f"(n_live {n_live} - shipped-from {ship_from})")
        if use < n_live:
            self._upload_host_pages(
                {name: _cpu_tensor(snap["pages"][name])[:, use - ship_from:]
                 for name in self._page_field_names()},
                self._table[slot, use:n_live], whole=True)
        rid = self._restore_request(snap, slot)
        self.pos[slot] = int(snap["pos"])
        self.last[slot] = int(snap["last"])
        self.active[slot] = True
        self._note_admitted(slot, prompt)   # prompt held for publication
        self.obs.counter(
            "kubetpu_migration_pages_remapped_total",
            "snapshot pages satisfied read-only by the local prefix "
            "cache instead of shipped bytes").inc(use)
        self.obs.counter(
            "kubetpu_migration_pages_shipped_total",
            "snapshot pages written into the pool from shipped "
            "bytes").inc(max(0, n_live - use))
        self.events.emit("migrate_in", rid=rid, slot=slot, reason=reason,
                         epoch=int(snap.get("epoch", 0)),
                         pages_shipped=max(0, n_live - use),
                         pages_remapped=use)
        return rid

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
        """Whole-prompt prefill as one final chunk, starting at the prefix
        match; a failed admission unmaps the shared prefix too (nothing may
        stay mutated)."""
        start = self._prefill_start(prompt, slot)
        res = self._prefill_chunk_device(prompt, slot, start,
                                         len(prompt) - start, True)
        if res is None and start:
            self._prefix_unmap(slot)
        return res

    def _chunk_io(self, write_row: np.ndarray, row: np.ndarray, n_gather):
        """The paged prefill strategy of one chunk: *write_row* the chunk
        pages' physical pages (-1 = dropped), *row* the slot's table."""
        write_phys = torch.from_numpy(
            np.where(write_row >= 0, write_row, self.pool_pages).astype(
                np.int64))
        return _paged_prefill_io(
            write_phys, self._upload(row[:n_gather].astype(np.int32)),
            self.page_size, self.cfg.window, attend_chunk=self._attend_chunk)

    @torch.no_grad()
    def _prefill_chunk_device(self, prompt: List[int], slot: int, pos: int,
                              take: int, final: bool):
        """One page-aligned prefill chunk through the pool, with
        chunk-granular page reservation (the final chunk reserves the
        decode worst case; a ring slot maps its whole ring up front). None
        when the pool cannot cover it (nothing mapped), True for a
        non-final chunk, the first token and its logprob (device scalars)
        for the final one."""
        if self._ring_pages or final:
            upto = self._worst_case_tokens(len(prompt))
        else:
            upto = pos + take
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
        # land on an unreserved page nor win an aliased ring page
        last_real = (pos + take - 1) // ps - p0
        write_row[last_real + 1:] = -1
        if self._ring_pages:
            # one scatter must not carry a physical page twice (undefined
            # winner on the card): keep the LAST logical occurrence of each
            # ring page; the earlier aliases are outside every later band
            seen = set()
            for i in range(len(write_row) - 1, -1, -1):
                p = int(write_row[i])
                if p < 0:
                    continue
                if p in seen:
                    write_row[i] = -1
                else:
                    seen.add(p)
        io = self._chunk_io(write_row, row,
                            self._gather_prefix(pos + bucket))
        tokens = self._upload(np.asarray([chunk], np.int64))
        lora, aid = self._admit_lora(slot)
        logits, _ = self._prefill_leg(self.cfg, self.params, tokens,
                                      (self._k_store, self._v_store), pos,
                                      io, lora, aid, self._lora_scale)
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
        lora, aids = self._step_lora()
        logits = self._step_leg(
            self.cfg, self.params, self.last, self._k_store, self._v_store,
            self._table_on_device(), pos, attend=self._attend,
            write_enable=active, lora=lora, adapter_ids=aids,
            lora_scale=self._lora_scale)
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

    @torch.no_grad()
    def warmup(self) -> None:
        """Flush the prefix tree and the host tier (the dummy prefills
        scribble on pool pages, tree-owned ones included, and a host buffer
        that outlived them could fill stale KV later), then run a dummy
        prefill chunk for every prompt bucket and one masked decode step,
        so every kernel is built and loaded and the allocator holds its
        blocks before the first request. Only valid on an idle server."""
        if self._prefix_cache is not None:
            self._free.extend(self._prefix_cache.clear())
        n = self._pages_needed(self.max_seq)
        row = np.full((self.max_pages_per_slot,), -1, np.int64)
        row[:n] = np.arange(n) % self.pool_pages

        def prefill_dummy(padded):
            io = self._chunk_io(row[:self._pages_needed(len(padded))], row,
                                self._gather_prefix(len(padded)))
            self._prefill_leg(self.cfg, self.params,
                              self._upload(np.zeros((1, len(padded)),
                                                    np.int64)),
                              (self._k_store, self._v_store), 0, io,
                              *self._admit_lora(0), self._lora_scale)

        self._warmup_buckets(prefill_dummy)
        zeros = np.zeros((self.n_slots,), np.int32)
        lora, aids = self._step_lora()
        self._step_leg(self.cfg, self.params, self.last, self._k_store,
                       self._v_store, self._table_on_device(),
                       self._upload(zeros), attend=self._attend,
                       write_enable=self._upload(zeros.astype(bool)),
                       lora=lora, adapter_ids=aids,
                       lora_scale=self._lora_scale)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
