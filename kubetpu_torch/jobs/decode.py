"""Chunk forward through a KV cache (port of ``kubetpu/jobs/decode.py:46-231``).

``forward_chunk_io`` runs T new tokens at positions ``pos..pos+T-1``
through the model while a pluggable cache strategy (``cache_io``) owns the
write and the read of each layer's cache — the paged pool's prefill
(``paged._paged_prefill_io``) plugs in here. The cache is a tree of tuples
whose every tensor leads with the layer axis; the Python loop over layers
hands each strategy its layer's views, and the strategies write those views
in place (no functional copy of the cache per layer, unlike the JAX
package's scan carry).
"""

from __future__ import annotations

import torch

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer


def _attend_cached(q, k_cache, v_cache, pos: int, window: int = 0):
    """Chunk attention through a contiguous cache: query t (at position
    pos+t) sees entries 0..pos+t, banded below by ``window`` when set.
    Grouped-query aware without expanding the cache. q: (B, T, H, D);
    caches: (B, S_max, H_kv, D). f32 scores and softmax."""
    b, t, h, d = q.shape
    h_kv = k_cache.shape[2]
    g = h // h_kv
    scale = d ** -0.5
    qg = q.reshape(b, t, h_kv, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    q_pos = pos + torch.arange(t, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]                 # (T, S_max)
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = scores.masked_fill(~mask, model_lib.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _decode_block_core(cfg: ModelConfig, layer, x, cache, pos, cache_io):
    """The transformer block of every cached decode path, parameterized on
    the cache strategy: ``cache_io(q, k, v, cache, pos) -> (attn, cache)``
    owns the write and the (banded) read; norms, projections, rope at the
    absolute positions and the MLP are shared. x: (B, T, D). (The JAX
    package's per-example LoRA branch is not ported yet.)"""
    h = model_lib.rms_norm(x, layer.ln1)
    q = torch.einsum("bsd,dhk->bshk", h, layer.wq)
    k = torch.einsum("bsd,dhk->bshk", h, layer.wk)
    v = torch.einsum("bsd,dhk->bshk", h, layer.wv)
    positions = pos + torch.arange(x.shape[1], dtype=torch.int32,
                                   device=x.device)
    positions = positions.expand(x.shape[0], x.shape[1])
    q = model_lib.rope(q, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    k = model_lib.rope(k, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    attn, cache = cache_io(q, k, v, cache, pos)
    x = x + torch.einsum("bshk,hkd->bsd", attn, layer.wo)
    x = x + model_lib._mlp(cfg, model_lib.rms_norm(x, layer.ln2), layer)
    return x, cache


def _layer(cache, i: int):
    """Layer *i*'s views of a cache tree (tuples of layer-leading tensors)."""
    if isinstance(cache, tuple):
        return tuple(_layer(c, i) for c in cache)
    return cache[i]


@torch.no_grad()
def forward_chunk_io(cfg: ModelConfig, params: Transformer, tokens, cache,
                     pos, cache_io):
    """The chunk forward over a cache strategy. tokens: (B, T) at positions
    ``pos..pos+T-1`` -> (logits (B, T, V) float32, cache). The strategy
    writes the cache in place; the same tree comes back."""
    x = params.embed[tokens]                               # (B, T, D)
    for i, layer in enumerate(params.blocks):
        x, _ = _decode_block_core(cfg, layer, x, _layer(cache, i), pos,
                                  cache_io)
    x = model_lib.rms_norm(x, params.ln_f)
    logits = torch.einsum("bsd,dv->bsv", x, params.head).float()
    return logits, cache
