"""Speculative decoding (port of ``kubetpu/jobs/speculative.py``): a small
draft model proposes ``gamma`` tokens, the target verifies them in one
batched cached forward, and the longest agreeing prefix is accepted plus one
correction or bonus token.

Greedy acceptance makes the output equal to target-only greedy decoding:
draft token j is accepted iff it equals the target's argmax given the same
prefix, and the first disagreement is replaced by the target's own choice
(when all gamma agree, the target's next argmax is the bonus token).
Rejected cache entries need no rollback: positions rewind, later rounds
overwrite them, and every attention mask is position-bounded.

The JAX package runs the rounds as one ``lax.while_loop``; here a round is a
Python loop of ``gamma`` draft steps and one verify chunk queued without a
host sync inside it, and ``make_speculative_generate`` reads one flag per
round (whether every row has its tokens) to stop.
"""

from __future__ import annotations

import torch

from kubetpu_torch.jobs.decode import forward_chunk_at, init_kv_cache, prefill
from kubetpu_torch.jobs.model import ModelConfig, Transformer


@torch.no_grad()
def draft_propose(draft_cfg: ModelConfig, gamma: int, draft_params, dk, dv,
                  last, pos):
    """Draft ``gamma`` greedy tokens one at a time through the draft's dense
    cache at per-row positions pos (B,) -> (dk, dv, drafts (B, gamma)); the
    caches are written in place. Shared by ``draft_and_verify`` and the
    paged speculative server. The last draft's K/V is written too
    (position pos + gamma): without it a fully accepted round would leave
    a hole the draft attends in every later round."""
    tok, p, drafts = last, pos, []
    for _ in range(gamma):
        logits, dk, dv = forward_chunk_at(draft_cfg, draft_params,
                                          tok[:, None], dk, dv, p)
        tok = torch.argmax(logits[:, 0], dim=-1)
        drafts.append(tok)
        p = p + 1
    forward_chunk_at(draft_cfg, draft_params, tok[:, None], dk, dv, p)
    return dk, dv, torch.stack(drafts, dim=1)


def _accepted(drafts, target_tok):
    """The length of each row's agreeing prefix: drafts (B, gamma) against
    the target's argmaxes target_tok (B, gamma+1)."""
    gamma = drafts.shape[1]
    agree = (drafts == target_tok[:, :gamma]).long()
    return torch.cumprod(agree, dim=1).sum(dim=1)


@torch.no_grad()
def draft_and_verify(target_cfg: ModelConfig, draft_cfg: ModelConfig,
                     gamma: int, target_params, draft_params, tk, tv, dk, dv,
                     last, pos):
    """One speculative round's device math, shared by the batch generate
    loop and the dense continuous-batching server: draft ``gamma`` tokens,
    verify them in one (gamma+1)-token target chunk of [last, d_0 ..
    d_{gamma-1}] at pos, and find the longest agreeing prefix -> (tk, tv,
    dk, dv, target_tok (B, gamma+1), accepted (B,), t_logits); per row,
    ``target_tok[:, :accepted+1]`` are the round's greedy emissions."""
    dk, dv, drafts = draft_propose(draft_cfg, gamma, draft_params, dk, dv,
                                   last, pos)
    chunk = torch.cat([last[:, None], drafts], dim=1)
    t_logits, tk, tv = forward_chunk_at(target_cfg, target_params, chunk, tk,
                                        tv, pos)
    target_tok = torch.argmax(t_logits, dim=-1)
    return tk, tv, dk, dv, target_tok, _accepted(drafts, target_tok), t_logits


def _scatter_rows(out, write_pos, values, valid):
    """out[b, write_pos[b, j]] = values[b, j] where valid[b, j], in place
    (the caller routes invalid writes to a sacrificial last column)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    cur = out[rows, write_pos]
    out[rows, write_pos] = torch.where(valid, values.to(out.dtype), cur)
    return out


def make_speculative_generate(target_cfg: ModelConfig,
                              draft_cfg: ModelConfig, gamma: int = 4):
    """``generate(target_params, draft_params, prompt (B, S_p), num_steps)
    -> ((B, S_p + num_steps) tokens, mean tokens per live round)``: greedy
    speculative decoding, output equal to target-only greedy decoding. Both
    models share the vocabulary; each round emits between 1 and gamma+1
    tokens per row."""
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError("target and draft must share a vocabulary")

    @torch.no_grad()
    def generate(target_params: Transformer, draft_params: Transformer,
                 prompt: torch.Tensor, num_steps: int):
        b, s_prompt = prompt.shape
        dev = prompt.device
        max_seq = s_prompt + num_steps + gamma + 1
        tk, tv = init_kv_cache(target_cfg, b, max_seq, device=dev)
        dk, dv = init_kv_cache(draft_cfg, b, max_seq, device=dev)
        t_logits, tk, tv = prefill(target_cfg, target_params, prompt, tk, tv)
        prefill(draft_cfg, draft_params, prompt, dk, dv)

        # the first emitted token: the target's own choice after the prompt
        last = torch.argmax(t_logits, dim=-1)
        out = torch.zeros((b, num_steps + gamma + 2), dtype=torch.long,
                          device=dev)
        out[:, 0] = last
        pos = torch.full((b,), s_prompt, dtype=torch.long, device=dev)
        count = torch.ones((b,), dtype=torch.long, device=dev)
        live_tokens = torch.zeros((), dtype=torch.float32, device=dev)
        live_rounds = torch.zeros((), dtype=torch.float32, device=dev)
        idx = torch.arange(gamma + 1, device=dev)[None, :]
        while bool((count < num_steps).any()):
            live = count < num_steps
            tk, tv, dk, dv, target_tok, accepted, _ = draft_and_verify(
                target_cfg, draft_cfg, gamma, target_params, draft_params,
                tk, tv, dk, dv, last, pos)
            n_emit = accepted + 1
            # emit target_tok[:, :n_emit] at out[count:count+n_emit];
            # writes past num_steps go to the sacrificial last column
            write_pos = count[:, None] + idx
            valid = (idx < n_emit[:, None]) & (write_pos < num_steps)
            write_pos = torch.where(valid, write_pos, out.shape[1] - 1)
            _scatter_rows(out, write_pos, target_tok, valid)
            last = torch.gather(target_tok, 1, (n_emit - 1)[:, None])[:, 0]
            pos = torch.clamp(pos + n_emit, max=s_prompt + num_steps)
            count = torch.clamp(count + n_emit, max=num_steps)
            # tokens actually written, so a round clipped at num_steps
            # does not inflate the rate
            written = valid.sum(dim=1)
            live_tokens += torch.where(live, written, 0).sum().float()
            live_rounds += live.sum().float()
        tokens = torch.cat([prompt, out[:, :num_steps].to(prompt.dtype)],
                           dim=1)
        mean = float(live_tokens / torch.clamp(live_rounds, min=1.0))
        return tokens, mean

    return generate
