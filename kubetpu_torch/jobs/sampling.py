"""Per-request token sampling for the serving paths (port of
``kubetpu/jobs/sampling.py:86-162``): temperature, per-row top-k and
nucleus (top-p) filters, and the raw-distribution logprob.

Filters mask logits to ``NEG_INF`` so one categorical draw samples the
renormalized distribution. Per-row draws come from a ``torch.Generator``
seeded from ``(seed, rid, position)`` (``row_seed``), so a request's tokens
depend on nothing else — not batch composition, chunking or step alignment.
The numbers differ from ``jax.random``'s; only greedy decoding is held to
the JAX package token for token.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit scramble."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_seed(*parts: int) -> int:
    """A 63-bit generator seed from integer parts — ``row_seed(seed, rid)``
    is a request's key, ``row_seed(request_key, position)`` the seed of its
    draw at *position*."""
    z = 0
    for p in parts:
        z = _mix64(z ^ (int(p) & _MASK64))
    return z >> 1


def apply_top_k_rows(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row top-k: *k* (...) int broadcast over the leading dims (0 =
    filter off for that row). Everything below the row's k-th largest
    logit becomes ``NEG_INF``."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(k - 1, 0, v - 1).long()
    thresh = torch.gather(sorted_desc, -1, idx[..., None])
    masked = torch.where(logits < thresh, NEG_INF, logits)
    return torch.where((k > 0)[..., None], masked, logits)


def apply_top_p_rows(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-row nucleus filter: keep the smallest set of tokens whose mass
    reaches *p* (the boundary token survives; ``p >= 1`` = filter off)."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p[..., None]
    cutoff = torch.where(keep_sorted, sorted_desc,
                         torch.full_like(sorted_desc, float("inf")))
    cutoff = cutoff.amin(dim=-1, keepdim=True)
    masked = torch.where(logits < cutoff, NEG_INF, logits)
    return torch.where((p < 1.0)[..., None], masked, logits)


def chosen_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(token) under the raw (unfiltered, untempered) distribution:
    logits (..., V), tokens (...) -> (...) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens.long()[..., None])[..., 0]


def make_slot_sampler():
    """``sample(logits (..., V), temperature, top_k, top_p, seeds) ->
    tokens (...)``: per-row settings as host arrays broadcast over the
    leading dims, *seeds* one generator seed per row (``row_seed``). Rows
    with temperature <= 0 are the exact argmax; an all-greedy batch runs
    only the argmax."""

    def sample(logits, temperature, top_k, top_p, seeds):
        greedy = torch.argmax(logits, dim=-1)
        shape = greedy.shape
        temp = np.broadcast_to(np.asarray(temperature, np.float32), shape)
        if (temp <= 0.0).all():
            return greedy
        dev = logits.device

        def rows(a, dtype):
            a = np.array(np.broadcast_to(np.asarray(a, dtype), shape))
            return torch.from_numpy(a).to(dev, non_blocking=True)

        t, tk, tp = (rows(temp, np.float32), rows(top_k, np.int64),
                     rows(top_p, np.float32))
        x = logits.float() / torch.clamp(t, min=1e-6)[..., None]
        x = apply_top_p_rows(apply_top_k_rows(x, tk), tp)
        flat_x = x.reshape(-1, x.shape[-1])
        out = greedy.reshape(-1).clone()
        flat_seeds = np.broadcast_to(np.asarray(seeds, dtype=object),
                                     shape).reshape(-1)
        for i in np.flatnonzero(temp.reshape(-1) > 0.0):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(flat_seeds[i]))
            probs = torch.softmax(flat_x[i], dim=-1)
            out[i] = torch.multinomial(probs, 1, generator=gen)[0]
        return out.reshape(shape)

    return sample
