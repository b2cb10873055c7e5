"""Beam search over the dense KV-cache decode path (port of
``kubetpu/jobs/beam.py``).

Beams fold into the batch axis: the cache is (L, B*K, S_max, H_kv, D), so
every matmul stays as large as plain decoding at batch B*K. Each step is a
flattened top-k over the K*V continuations of each example, a parent-beam
gather that reorders both caches along the beam axis (an ``index_select``
over the (L, B, K, ...) view's flattened rows), and a T=1 forward through
``decode.forward_chunk`` — the chunk forward of greedy decoding and
speculative verification, so the three paths cannot diverge. The search
stays on the device; the caller's read of the result is its one host sync.

Order among equal scores is the reference's: ``jax.lax.top_k`` puts the
lower flat index first and the final ``argsort`` is stable, so both are
stable sorts here (``torch.topk`` promises no order among ties). Ties are
not rare: the first step's beams 1..K-1 and a pinned beam's non-EOS
continuations all score exactly ``-1e30`` in f32.

EOS semantics: a finished beam is pinned — its only continuation is EOS at
log-probability 0, so its score freezes while shapes stay static. The
final ranking applies the GNMT length penalty ``((5 + len) / 6) ** alpha``
when ``length_penalty > 0``.

Over a mesh (``mesh=``: dp and tp) every rank passes the whole prompt
batch and the model (whole, cut here, or its shard): the prompt rows go on
dp, each rank's caches hold its rows' beams at its ``H_kv/tp`` heads
((L, B·K/dp, S, H_kv/tp, D), the JAX package's ``kv_cache_specs``), the
logits are gathered over tp before the log-softmax and the top-k, the
parent reorder stays within the rank's own rows, and the sequences and
scores are gathered over dp, so every rank returns the whole result.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs.decode import _forward_one, init_kv_cache, prefill
from kubetpu_torch.jobs.model import (NEG_INF, ModelConfig, _top_k,
                                      resolve_device)


def _gnmt_penalty(length: torch.Tensor, alpha: float) -> torch.Tensor:
    return ((5.0 + length.float()) / 6.0) ** alpha


def make_beam_search(cfg: ModelConfig, beam_size: int, mesh=None,
                     length_penalty: float = 0.0,
                     eos_id: Optional[int] = None, device=None):
    """``beam_search(params, prompt (B, S_p), num_steps) -> (tokens (B, K,
    S_p + num_steps), scores (B, K))``, beams sorted best-first. ``scores``
    are summed token log-probabilities (length-penalized iff
    ``length_penalty > 0``); finished beams pad with EOS at a frozen score.
    The prompt (a tensor or an array) is moved to *device*, the card by
    default."""
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    dev = resolve_device(device)
    k = beam_size
    tp, groups = 1, None
    if mesh is not None:
        from kubetpu_torch.jobs.train import check_mesh

        check_mesh(cfg, mesh)
        if col.axis_size(mesh, "sp") > 1:
            raise ValueError("beam search over a mesh takes dp and tp "
                             "(sp is a training axis)")
        groups = col.groups_of(mesh)
        tp = col.axis_size(mesh, "tp")

    @torch.no_grad()
    def beam_search(params, prompt, num_steps: int):
        prompt = torch.as_tensor(prompt).to(dev)
        shard = None
        if mesh is not None:
            from kubetpu_torch.jobs.train import shard_model

            params = shard_model(params, cfg, mesh)
            shard = params.shard.with_data(groups, ("dp",))
            dp = col.axis_size(mesh, "dp")
            if prompt.shape[0] % dp:
                raise ValueError(f"dp={dp} does not divide the batch "
                                 f"({prompt.shape[0]})")
            rows = prompt.shape[0] // dp
            r0 = col.axis_index(mesh, "dp") * rows
            prompt = prompt[r0:r0 + rows]
        b, s_p = prompt.shape
        k_cache, v_cache = init_kv_cache(cfg, b, s_p + num_steps, device=dev,
                                         tp=tp)
        logits, k_cache, v_cache = prefill(cfg, params, prompt, k_cache,
                                           v_cache, shard=shard)
        # the beam axis rides inside the batch axis: (L, B*K, ...)
        k_cache = k_cache.repeat_interleave(k, dim=1)
        v_cache = v_cache.repeat_interleave(k, dim=1)
        logits = logits.repeat_interleave(k, dim=0)          # (B*K, V)
        # beam 0 starts at score 0, the rest at -1e30: the first flattened
        # top-k then draws K distinct tokens from beam 0
        scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        gen_len = torch.zeros((b, k), dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)[:, None] * k      # (B, 1)
        v = logits.shape[-1]
        if eos_id is not None:
            # a finished beam's one continuation: EOS at log-probability 0
            pin = torch.full((v,), NEG_INF, device=dev)
            pin[eos_id] = 0.0
        tokens, parents = [], []
        for i in range(num_steps):
            logp = torch.log_softmax(logits.float(), dim=-1).view(b, k, v)
            if eos_id is not None:
                logp = torch.where(finished[:, :, None], pin, logp)
            flat = (scores[:, :, None] + logp).reshape(b, k * v)
            scores, idx = _top_k(flat, k)                    # (B, K)
            parent = idx // v
            token = (idx % v).to(prompt.dtype)
            was_finished = torch.gather(finished, 1, parent)
            gen_len = torch.gather(gen_len, 1, parent)
            gen_len = torch.where(was_finished, gen_len, gen_len + 1)
            finished = (was_finished | (token == eos_id) if eos_id is not None
                        else was_finished)
            tokens.append(token)
            parents.append(parent)
            if i + 1 < num_steps:     # the last token's K/V is never read
                # reorder the caches to each new beam's parent
                src = (rows + parent).reshape(-1)
                k_cache = k_cache.index_select(1, src)
                v_cache = v_cache.index_select(1, src)
                logits, k_cache, v_cache = _forward_one(
                    cfg, params, token.reshape(b * k), k_cache, v_cache,
                    s_p + i, shard=shard)
        # backtrack: tokens[t] were chosen for step t's beams, and later
        # steps reorder the ancestry: walk the parents from the last step
        beam_idx = torch.arange(k, device=dev).expand(b, k)
        rev = []
        for token, parent in zip(reversed(tokens), reversed(parents)):
            rev.append(torch.gather(token, 1, beam_idx))
            beam_idx = torch.gather(parent, 1, beam_idx)
        seq = (torch.stack(rev[::-1], dim=-1) if rev else
               prompt.new_zeros((b, k, 0)))                  # (B, K, steps)
        final = scores
        if length_penalty > 0:
            final = scores / _gnmt_penalty(gen_len, length_penalty)
        order = torch.sort(-final, dim=1, stable=True).indices
        seq = torch.gather(seq, 1, order[:, :, None].expand_as(seq))
        final = torch.gather(final, 1, order)
        prompt_k = prompt[:, None].expand(b, k, s_p)
        seq = torch.cat([prompt_k, seq], dim=-1)
        if groups is not None:
            # token ids ride as f32 (exact below 2**24: the dtypes gloo
            # takes on CUDA tensors)
            dp_group = groups.over("dp")
            seq = col.all_gather(seq.float(), dp_group, "dp_tokens",
                                 dim=0).to(prompt.dtype)
            final = col.all_gather(final.contiguous(), dp_group, "dp_tokens",
                                   dim=0)
        return seq, final

    return beam_search
