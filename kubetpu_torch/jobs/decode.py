"""Autoregressive decoding with a KV cache (port of ``kubetpu/jobs/decode.py``).

The core is the T-token chunk forward through a cache (``forward_chunk_io``):
plain decoding is its T == 1 case, speculative verification
(``kubetpu_torch.jobs.speculative``) its T == gamma+1 case, and a pluggable
cache strategy (``cache_io``) owns each layer's write and read — the dense
contiguous cache (``_dense_cache_io``), its int8 form (``_int8_cache_io``)
and the paged pool's prefill (``paged._paged_prefill_io``) plug in here.
The cache is a tree of tuples whose every tensor leads with the layer axis;
the Python loop over layers hands each strategy its layer's views, and the
strategies write those views in place (no functional copy of the cache per
layer, unlike the JAX package's scan carry).

Positions are an int (every row at the same offset) or a (B,) tensor (per
row: ``forward_chunk_at_io``, the serving step and the draft step, where
the JAX package vmaps over the batch). A write whose chunk would run past
the cache end lands at ``S_max - T``, as ``lax.dynamic_update_slice``
clamps it; the mask and the rotary positions keep the unclamped position.

``make_generate`` is the batch generate loop (greedy, or seeded sampling
through the serving sampler). ``make_rolling_generate`` generates on a
sliding-window config from a ring of ``cfg.window`` cache slots a layer
(``_ring_cache_io``), sampling through ``sampling.make_sampler``.

int8 weights (``quant.quantize_params``) dequantize one layer at a time
inside the layer loop (``_decode_block_core``) and the head per use, never
as a whole-model copy.

A model shard (``train.shard_model``) decodes tensor-parallel through its
``collectives.ModelShard``: ``copy_to`` before q/k/v and the MLP,
``reduce_from`` after ``wo`` (its LoRA delta inside the sum: its input is
the rank's heads) and after the MLP, the cache holding the rank's
``H_kv/tp`` heads (``init_kv_cache(..., tp=)``), and the head's vocab
shards gathered into whole f32 logits before any sampler, so every rank
samples from the same row. ``make_generate(..., mesh=)`` puts the prompt
batch on dp and gathers the generated rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.quant import maybe_dequantize, quantize_kv_chunk


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
                  tp: int = 1):
    """(k_cache, v_cache), each (L, B, S_max, H_kv, D) zeros in
    ``cfg.dtype``: the cache holds only the kv heads under grouped-query
    attention (a tp rank's ``H_kv/tp`` of them)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads // tp, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_kv_cache_int8(cfg: ModelConfig, batch: int, max_seq: int,
                       device=None, tp: int = 1):
    """int8 KV cache: ((k_q, k_scale), (v_q, v_scale)) with int8 values
    (L, B, S_max, H_kv, D) and per-token, per-head f32 scales
    (L, B, S_max, H_kv, 1) (a tp rank's ``H_kv/tp`` heads). Entries
    quantize at write time (``quant.quantize_kv_chunk``) and dequantize on
    read."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads // tp, cfg.head_dim)
    sshape = shape[:-1] + (1,)

    def pair():
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device))

    return pair(), pair()


def _query_positions(pos, t: int, device) -> torch.Tensor:
    """(T,) for an int *pos*, (B, T) for a (B,) tensor: pos + 0..T-1."""
    steps = torch.arange(t, device=device)
    if isinstance(pos, torch.Tensor):
        return pos.long()[:, None] + steps
    return pos + steps


def _attend_cached(q, k_cache, v_cache, pos, window: int = 0):
    """Chunk attention through a contiguous cache: query t (at position
    pos+t) sees entries 0..pos+t, banded below by ``window`` when set.
    Grouped-query aware without expanding the cache. q: (B, T, H, D);
    caches: (B, S_max, H_kv, D); pos an int or (B,). f32 scores and
    softmax."""
    b, t, h, d = q.shape
    h_kv = k_cache.shape[2]
    g = h // h_kv
    scale = d ** -0.5
    qg = q.reshape(b, t, h_kv, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = _query_positions(pos, t, q.device)[..., None]   # ([B,] T, 1)
    mask = k_pos <= q_pos                                   # ([B,] T, S)
    if window > 0:
        mask &= q_pos - k_pos < window
    if mask.dim() == 3:
        mask = mask[:, None, None]
    scores = scores.masked_fill(~mask, model_lib.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _write_at(cache_l, new, pos) -> None:
    """Write a chunk new (B, T, ...) into cache_l (B, S_max, ...) in place
    at rows pos..pos+T-1 (pos an int or (B,)), the start clamped into
    [0, S_max - T] as ``lax.dynamic_update_slice`` clamps it."""
    b, t = new.shape[:2]
    limit = cache_l.shape[1] - t
    if not isinstance(pos, torch.Tensor):
        start = min(max(int(pos), 0), limit)
        cache_l[:, start:start + t] = new
        return
    start = torch.clamp(pos.long(), 0, limit)
    rows = start[:, None] + torch.arange(t, device=new.device)
    batch = torch.arange(b, device=new.device)[:, None]
    cache_l[batch, rows] = new


def _dense_cache_io(window: int):
    """The (L, B, S_max, ...) contiguous-cache strategy: write the chunk at
    *pos*, attend through the whole (banded) cache."""
    def io(q, k, v, cache, pos):
        k_l, v_l = cache
        _write_at(k_l, k.to(k_l.dtype), pos)
        _write_at(v_l, v.to(v_l.dtype), pos)
        return _attend_cached(q, k_l, v_l, pos, window=window), cache

    return io


def _int8_cache_io(window: int):
    """The int8 contiguous-cache strategy: quantize the chunk's K/V per
    token and head on write, dequantize on read (convert, then scale, in
    f32), with ``_dense_cache_io``'s banded read."""
    def io(q, k, v, cache, pos):
        (kq, ksc), (vq, vsc) = cache
        k8, ks = quantize_kv_chunk(k)
        v8, vs = quantize_kv_chunk(v)
        _write_at(kq, k8, pos)
        _write_at(ksc, ks, pos)
        _write_at(vq, v8, pos)
        _write_at(vsc, vs, pos)
        attn = _attend_cached(q, kq.float() * ksc, vq.float() * vsc, pos,
                              window=window)
        return attn, cache

    return io


def _lora_in(out, h, a, b, scale: float):
    """*out* (B, T, H, hd) plus each row's input-projection delta: h
    (B, T, D) through a (B, D, r), then b (B, r, H, hd), times *scale*.
    One batched matmul into the rank-r bottleneck and one fused
    multiply-add out of it (``baddbmm``): the fewest launches, and the
    fewest host-side ops, a target costs."""
    bsz, t = out.shape[:2]
    hr = torch.bmm(h, a)                                   # (B, T, r)
    return torch.baddbmm(out.reshape(bsz, t, -1), hr,
                         b.reshape(bsz, b.shape[1], -1),
                         alpha=scale).view(out.shape)


def _lora_out(o, attn, a, b, scale: float):
    """*o* (B, T, D) plus each row's output-projection delta: attn
    (B, T, H, hd) through a (B, H, hd, r), then b (B, r, D), times
    *scale*."""
    bsz, t = attn.shape[:2]
    ar = torch.bmm(attn.reshape(bsz, t, -1),
                   a.reshape(bsz, -1, a.shape[-1]))          # (B, T, r)
    return torch.baddbmm(o, ar, b, alpha=scale)


def select_lora(lora, adapter_ids):
    """Each row's adapter factors, gathered once per forward: the stacked
    tree's leaves (N, L, ...) indexed by *adapter_ids* (B,) on the adapter
    axis straight into layer-major (L, B, ...) tensors (one gather a leaf,
    reading only the selected adapters), then split by layer -> one
    {leaf: (B, ...)} dict a layer of contiguous views (``lora_layer``),
    which the batched matmuls take without a copy. None without adapters:
    no LoRA op runs at all."""
    if lora is None:
        return None
    per_leaf = {k: v.transpose(0, 1)[:, adapter_ids].unbind(0)
                for k, v in lora["blocks"].items()}
    n_layers = len(next(iter(per_leaf.values())))
    return [{k: views[i] for k, views in per_leaf.items()}
            for i in range(n_layers)]


def lora_layer(sel, i: int):
    """Layer *i*'s per-row factors of a ``select_lora`` result."""
    return None if sel is None else sel[i]


def project(name: str, h, w, lora_l, scale: float):
    """An input projection ``h @ w`` (B, T, D) x (D, H, hd), plus each
    row's adapter delta when *lora_l* holds factors for target *name*."""
    out = torch.einsum("bsd,dhk->bshk", h, w)
    if lora_l is not None and f"{name}_a" in lora_l:
        out = _lora_in(out, h, lora_l[f"{name}_a"], lora_l[f"{name}_b"],
                       scale)
    return out


def out_project(attn, wo, lora_l, scale: float):
    """The output projection (B, T, H, hd) x (H, hd, D), plus each row's
    ``wo`` delta."""
    o = torch.einsum("bshk,hkd->bsd", attn, wo)
    if lora_l is not None and "wo_a" in lora_l:
        o = _lora_out(o, attn, lora_l["wo_a"], lora_l["wo_b"], scale)
    return o


def _decode_block_core(cfg: ModelConfig, layer, x, cache, pos, cache_io,
                       lora_l=None, lora_scale: float = 1.0,
                       per_row: bool = False, shard=None):
    """The transformer block of every cached decode path, parameterized on
    the cache strategy: ``cache_io(q, k, v, cache, pos) -> (attn, cache)``
    owns the write and the (banded) read; norms, projections (with each
    row's adapter deltas when *lora_l* holds per-row factors, the
    multi-LoRA path), rope at the absolute positions and the MLP are
    shared. An int8 layer dequantizes here, for this layer only;
    *per_row* makes each row its own MoE dispatch (``model._mlp``). On a
    *shard* the rank's heads run between ``copy_to`` and the
    ``reduce_from`` that also sums ``wo``'s LoRA delta. x: (B, T, D); pos
    an int or (B,)."""
    tp = None if shard is None else shard.tp
    layer = maybe_dequantize(layer)
    h = col.copy_to(model_lib.rms_norm(x, layer.ln1), tp)
    q = project("wq", h, layer.wq, lora_l, lora_scale)
    k = project("wk", h, layer.wk, lora_l, lora_scale)
    v = project("wv", h, layer.wv, lora_l, lora_scale)
    positions = _query_positions(pos, x.shape[1], x.device).to(torch.int32)
    positions = positions.expand(x.shape[0], x.shape[1])
    q = model_lib.rope(q, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    k = model_lib.rope(k, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    attn, cache = cache_io(q, k, v, cache, pos)
    x = x + col.reduce_from(out_project(attn, layer.wo, lora_l, lora_scale),
                            tp)
    delta, _aux = model_lib._mlp(cfg, model_lib.rms_norm(x, layer.ln2), layer,
                                 per_row, shard)
    return x + delta, cache


def _decode_block(cfg: ModelConfig, layer, x, k_cache_l, v_cache_l, pos):
    """One block over a T-token chunk through this layer's dense cache
    (B, S_max, H_kv, D), which takes the chunk's K/V in place ->
    (x, k_cache_l, v_cache_l)."""
    x, (k_cache_l, v_cache_l) = _decode_block_core(
        cfg, layer, x, (k_cache_l, v_cache_l), pos,
        _dense_cache_io(cfg.window))
    return x, k_cache_l, v_cache_l


def _layer(cache, i: int):
    """Layer *i*'s views of a cache tree (tuples of layer-leading tensors)."""
    if isinstance(cache, tuple):
        return tuple(_layer(c, i) for c in cache)
    return cache[i]


def _rows(cache, index):
    """Views of a cache tree's batch rows *index* (a slice), for a
    single-slot leg that writes through them in place."""
    if isinstance(cache, tuple):
        return tuple(_rows(c, index) for c in cache)
    return cache[:, index]


@torch.no_grad()
def forward_chunk_io(cfg: ModelConfig, params: Transformer, tokens, cache,
                     pos, cache_io, lora=None, adapter_ids=None,
                     lora_scale: float = 1.0, per_row: bool = False,
                     shard=None):
    """The chunk forward over a cache strategy. tokens: (B, T) at positions
    ``pos..pos+T-1`` (pos an int or (B,)) -> (logits (B, T, V) float32,
    cache). The strategy writes the cache in place; the same tree comes
    back. ``lora`` (a stacked adapter tree, leaves (N, L, ...)) with
    ``adapter_ids`` (B,) on its device applies row b's adapter to row b
    (``kubetpu_torch.jobs.multi_lora``), the factors gathered once.
    *per_row*: each row is its own MoE capacity dispatch. *shard*
    defaults to the model's own (``Transformer.shard``)."""
    if shard is None:
        shard = getattr(params, "shard", None)
    x = params.embed[tokens]                               # (B, T, D)
    sel = select_lora(lora, adapter_ids)
    for i, layer in enumerate(params.blocks):
        x, _ = _decode_block_core(cfg, layer, x, _layer(cache, i), pos,
                                  cache_io, lora_layer(sel, i), lora_scale,
                                  per_row, shard)
    return _head(params, x, shard), cache


def _head(params: Transformer, x: torch.Tensor, shard=None) -> torch.Tensor:
    """Final norm and LM head (dequantized for this use) -> f32 logits,
    a shard's vocab shards gathered over tp into the whole row."""
    x = model_lib.rms_norm(x, params.ln_f)
    return model_lib.shard_logits(
        torch.einsum("bsd,dv->bsv", x, maybe_dequantize(params.head)).float(),
        shard)


def forward_chunk(cfg: ModelConfig, params: Transformer, tokens, k_cache,
                  v_cache, pos, lora=None, adapter_ids=None,
                  lora_scale: float = 1.0, shard=None):
    """Logits (B, T, V) f32 for a T-token chunk at pos..pos+T-1 through the
    dense cache, which takes the chunk's K/V -> (logits, k_cache,
    v_cache)."""
    logits, _ = forward_chunk_io(cfg, params, tokens, (k_cache, v_cache),
                                 pos, _dense_cache_io(cfg.window), lora,
                                 adapter_ids, lora_scale, shard=shard)
    return logits, k_cache, v_cache


def _forward_one(cfg: ModelConfig, params: Transformer, token, k_cache,
                 v_cache, pos, shard=None):
    """Logits (B, V) f32 for one new token a row (token (B,)) at *pos*,
    through the dense cache -> (logits, k_cache, v_cache): a T=1
    ``forward_chunk``."""
    logits, k_cache, v_cache = forward_chunk(cfg, params, token[:, None],
                                             k_cache, v_cache, pos,
                                             shard=shard)
    return logits[:, 0], k_cache, v_cache


def forward_chunk_at_io(cfg: ModelConfig, params: Transformer, chunk, cache,
                        pos, cache_io, lora=None, adapter_ids=None,
                        lora_scale: float = 1.0):
    """``forward_chunk_io`` at per-row positions pos (B,): serving slots
    and speculative rounds advance each sequence unevenly. Every cache
    layout rides the same batched call. The JAX package vmaps this leg
    over the batch, so each row is its own MoE capacity dispatch here too
    (its N is the chunk's T, never the batch's rows)."""
    return forward_chunk_io(cfg, params, chunk, cache, pos, cache_io, lora,
                            adapter_ids, lora_scale, per_row=True)


def forward_chunk_at(cfg: ModelConfig, params: Transformer, chunk, k_cache,
                     v_cache, pos, lora=None, adapter_ids=None,
                     lora_scale: float = 1.0):
    """``forward_chunk`` at per-row positions: the dense-cache spelling of
    ``forward_chunk_at_io`` -> (logits, k_cache, v_cache)."""
    logits, _ = forward_chunk_at_io(cfg, params, chunk, (k_cache, v_cache),
                                    pos, _dense_cache_io(cfg.window), lora,
                                    adapter_ids, lora_scale)
    return logits, k_cache, v_cache


def _prefill_with(cfg, params, tokens, write, attn_fn=None, shard=None):
    """The prefill body: one batched forward over the whole prompt
    (``model.forward_with_kv``), K/V landing in the cache through *write*."""
    logits, ks, vs = model_lib.forward_with_kv(params, tokens, cfg,
                                               attn_fn=attn_fn, shard=shard)
    write(ks, vs)
    return logits


def prefill(cfg: ModelConfig, params: Transformer, tokens, k_cache, v_cache,
            attn_fn=None, shard=None):
    """Fill the cache from one batched forward over the prompt (B, S_p) ->
    (last position's logits (B, V) f32, k_cache, v_cache)."""
    def write(ks, vs):
        s = ks.shape[2]
        k_cache[:, :, :s] = ks.to(k_cache.dtype)
        v_cache[:, :, :s] = vs.to(v_cache.dtype)

    logits = _prefill_with(cfg, params, tokens, write, attn_fn, shard)
    return logits, k_cache, v_cache


def prefill_int8(cfg: ModelConfig, params: Transformer, tokens, cache,
                 attn_fn=None, shard=None):
    """``prefill`` for the int8 cache: the prompt's K/V quantize into it in
    one shot -> (logits, cache)."""
    (kq, ksc), (vq, vsc) = cache

    def write(ks, vs):
        s = ks.shape[2]
        k8, kscale = quantize_kv_chunk(ks)
        v8, vscale = quantize_kv_chunk(vs)
        kq[:, :, :s] = k8
        ksc[:, :, :s] = kscale
        vq[:, :, :s] = v8
        vsc[:, :, :s] = vscale

    return _prefill_with(cfg, params, tokens, write, attn_fn, shard), cache


def make_generate(cfg: ModelConfig, temperature: float = 0.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  kv_int8: bool = False, mesh=None):
    """``generate(params, prompt (B, S_p), seed, num_steps) -> (B, S_p +
    num_steps)`` tokens. Greedy when temperature == 0; otherwise row b's
    draw at position q is seeded from (seed, b, q) through the serving
    sampler (``sampling.make_slot_sampler``: temperature, top-k and
    nucleus compose). ``kv_int8=True`` stores the cache in int8 with
    per-token, per-head scales. One loop body serves both layouts: only
    the (init, prefill, cache_io) triple differs.

    With *mesh* (dp and tp axes; every rank calls ``generate`` with the
    same whole prompt batch, and *params* the whole model, cut here, or
    its ``train.shard_model`` shard): each dp rank decodes its block of
    the rows into a (L, B/dp, S, H_kv/tp, D) cache (the JAX package's
    ``kv_cache_specs``), tensor-parallel over tp, and the generated rows
    are gathered over dp, so every rank returns the whole batch. A MoE
    capacity dispatch spans the rows of every dp rank, as one call over
    the batch does."""
    from kubetpu_torch.jobs.sampling import make_slot_sampler, row_seed

    sampler = make_slot_sampler()
    tp, groups = 1, None
    if mesh is not None:
        from kubetpu_torch.jobs.train import check_mesh

        check_mesh(cfg, mesh)
        if col.axis_size(mesh, "sp") > 1:
            raise ValueError("make_generate over a mesh takes dp and tp "
                             "(sp is a training axis)")
        groups = col.groups_of(mesh)
        tp = col.axis_size(mesh, "tp")

    @torch.no_grad()
    def generate(params: Transformer, prompt: torch.Tensor, seed: int,
                 num_steps: int) -> torch.Tensor:
        shard, r0 = None, 0
        if mesh is not None:
            from kubetpu_torch.jobs.train import shard_model

            params = shard_model(params, cfg, mesh)
            shard = params.shard.with_data(groups, ("dp",))
            r0, dp = col.axis_index(mesh, "dp"), col.axis_size(mesh, "dp")
            if prompt.shape[0] % dp:
                raise ValueError(f"dp={dp} does not divide the batch "
                                 f"({prompt.shape[0]})")
            rows = prompt.shape[0] // dp
            r0 *= rows
            prompt = prompt[r0:r0 + rows]
        b, s_prompt = prompt.shape
        max_seq = s_prompt + num_steps
        dev = prompt.device
        if kv_int8:
            cache = init_kv_cache_int8(cfg, b, max_seq, device=dev, tp=tp)
            logits, cache = prefill_int8(cfg, params, prompt, cache,
                                         shard=shard)
            cache_io = _int8_cache_io(cfg.window)
        else:
            cache = init_kv_cache(cfg, b, max_seq, device=dev, tp=tp)
            logits, *cache = prefill(cfg, params, prompt, *cache,
                                     shard=shard)
            cache = tuple(cache)
            cache_io = _dense_cache_io(cfg.window)
        out = []
        for i in range(num_steps):
            seeds = None
            if temperature > 0:
                seeds = [row_seed(seed, r0 + r, s_prompt + i)
                         for r in range(b)]
            token = sampler(logits, temperature, top_k or 0, top_p or 1.0,
                            seeds)
            out.append(token)
            if i + 1 < num_steps:     # the last token's K/V is never read
                logits, cache = forward_chunk_io(
                    cfg, params, token[:, None], cache, s_prompt + i,
                    cache_io, shard=shard)
                logits = logits[:, 0]
        generated = torch.cat([prompt, torch.stack(out, dim=1).to(
            prompt.dtype)], dim=1)
        if groups is not None:
            # token ids ride as f32 (exact below 2**24: the dtypes gloo
            # takes on CUDA tensors)
            generated = col.all_gather(generated.float(), groups.over("dp"),
                                       "dp_tokens", dim=0).to(prompt.dtype)
        return generated

    return generate


def init_ring_cache(cfg: ModelConfig, batch: int, device=None):
    """(k_rings, v_rings), each (L, B, W, H_kv, D) zeros in ``cfg.dtype``
    with W = ``cfg.window``: the rolling generate's whole cache, whatever
    the sequence length."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.window, cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _attend_ring(q, k_ring, v_ring, q_pos: int, window: int,
                 first_pos: int):
    """One query a row over a ring cache: q (B, 1, H, D); rings (B, W,
    H_kv, D). Slot j holds the unique position p = j (mod W) in
    (q_pos - W, q_pos], visible once written (p >= *first_pos*, the
    earliest position the ring ever held). Grouped-query aware; f32 scores
    and softmax."""
    b, t, h, d = q.shape
    h_kv = k_ring.shape[2]
    g = h // h_kv
    qg = q.reshape(b, h_kv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_ring.float()) * d ** -0.5
    slots = torch.arange(window, device=q.device)
    visible = q_pos - torch.remainder(q_pos - slots, window) >= first_pos
    scores = scores.masked_fill(~visible, model_lib.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_ring.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _ring_cache_io(window: int, first_pos: int):
    """The O(window) ring strategy for one-token chunks: write at
    ``pos % window`` (the entry overwritten is outside every later band),
    attend over the W slots."""
    def io(q, k, v, cache, pos):
        k_l, v_l = cache
        slot = pos % window
        k_l[:, slot:slot + 1] = k.to(k_l.dtype)
        v_l[:, slot:slot + 1] = v.to(v_l.dtype)
        return _attend_ring(q, k_l, v_l, pos, window, first_pos), cache

    return io


def make_rolling_generate(cfg: ModelConfig, temperature: float = 0.0,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None):
    """``make_generate`` for sliding-window configs with an O(window)
    cache: each layer's K/V live in a ring of ``cfg.window`` slots, so
    generation memory is bounded by the window, not the sequence. Keys are
    roped at their absolute positions before they enter the ring, so the
    tokens equal ``make_generate``'s on the same windowed config. Prefill
    is the batched windowed forward (``model.forward_with_kv``, dequantizing
    an int8 model a layer at a time); the ring keeps its last
    ``min(S_p, W)`` K/V.

    -> ``generate(params, prompt (B, S_p), seed, num_steps) -> (B, S_p +
    num_steps)``, sampling through ``sampling.make_sampler`` with one
    ``torch.Generator`` seeded from *seed* (greedy when temperature == 0)."""
    from kubetpu_torch.jobs.sampling import make_sampler

    if cfg.window <= 0:
        raise ValueError("make_rolling_generate needs cfg.window > 0")
    w = cfg.window
    sampler = make_sampler(temperature, top_k=top_k, top_p=top_p)

    @torch.no_grad()
    def generate(params: Transformer, prompt: torch.Tensor, seed: int,
                 num_steps: int) -> torch.Tensor:
        b, s_p = prompt.shape
        dev = prompt.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        logits, ks, vs = model_lib.forward_with_kv(params, prompt, cfg)
        k_rings, v_rings = init_ring_cache(cfg, b, device=dev)
        first_pos = s_p - min(s_p, w)     # earliest position the ring holds
        slots = torch.arange(first_pos, s_p, device=dev) % w
        k_rings[:, :, slots] = ks[:, :, first_pos:].to(cfg.dtype)
        v_rings[:, :, slots] = vs[:, :, first_pos:].to(cfg.dtype)
        cache_io = _ring_cache_io(w, first_pos)
        out = []
        for i in range(num_steps):
            token = sampler(logits, gen)
            out.append(token)
            if i + 1 < num_steps:     # the last token's K/V is never read
                logits, _ = forward_chunk_io(
                    cfg, params, token[:, None], (k_rings, v_rings),
                    s_p + i, cache_io)
                logits = logits[:, 0]
        generated = torch.stack(out, dim=1).to(prompt.dtype)
        return torch.cat([prompt, generated], dim=1)

    return generate
