"""Draft-model construction for speculative decoding: distillation and
truncated self-drafts (port of ``kubetpu/jobs/distill.py``).

Speculation only pays when the draft AGREES with the target. Two ways to a
high-agreement draft:

- ``make_distill_step``: train a small draft against the FROZEN target's
  logits (soft cross-entropy at a temperature, optionally mixed with the
  data CE). Greedy agreement is exactly what speculation accepts, and
  matching the teacher's distribution maximizes it where it matters (the
  teacher's argmax).
- ``truncated_draft``: a zero-training draft — the first ``n_layers`` of
  the target plus its own final norm/head. Useful as a starting point
  for distillation and as the self-draft upper-bound harness.

The distillation objective is the standard Hinton softening. The step runs
the teacher's forward under ``torch.no_grad`` and the draft's forward and
backward through training's attention core (the flash kernels on the
card, their plain versions on the CPU), then the port's ``AdamW`` through
``train.make_update_step``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.train import (AdamW, TrainState, _resolve_attention,
                                      _uploader, make_optimizer,
                                      make_update_step, state_from_params)


def truncated_draft(cfg: ModelConfig, params: Transformer,
                    n_layers: int) -> Tuple[ModelConfig, Transformer]:
    """Draft = the target's first *n_layers* blocks + its embed/ln_f/head
    (the same tensors, no copy)."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers must be in (0, {cfg.n_layers}]")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    draft = Transformer(dcfg, torch.device("meta"))
    for name in ("embed", "ln_f", "head"):
        delattr(draft, name)
        setattr(draft, name, getattr(params, name))
    draft.blocks = nn.ModuleList(list(params.blocks)[:n_layers])
    return dcfg, draft


def _draft_logits(draft_cfg, draft_params, tokens, attn_fn):
    """The draft's logits, differentiable (``model.forward`` runs without
    gradients)."""
    x, _aux = model_lib.forward_hidden(draft_params, tokens, draft_cfg,
                                       attn_fn)
    return torch.einsum("bsd,dv->bsv", x, draft_params.head)


def distill_loss(
    draft_cfg: ModelConfig,
    draft_params: Transformer,
    target_logits: torch.Tensor,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    temperature: float = 1.0,
    hard_weight: float = 0.5,
    attn_fn=None,
) -> torch.Tensor:
    """Soft CE against the teacher's logits + ``hard_weight`` x data CE.
    The T^2 factor keeps the soft-gradient scale independent of the
    softening temperature (Hinton et al.). *attn_fn*: the draft's attention
    core (``model.dense_attention`` by default)."""
    d_logits = _draft_logits(draft_cfg, draft_params, tokens,
                             attn_fn).float()
    t_soft = torch.softmax(target_logits.float() / temperature, dim=-1)
    d_logsoft = torch.log_softmax(d_logits / temperature, dim=-1)
    soft = -(t_soft * d_logsoft).sum(dim=-1).mean() * temperature ** 2
    # hard CE from the SAME logits (one draft forward per step, not two)
    logp = torch.log_softmax(d_logits, dim=-1)
    hard = -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()
    return soft + hard_weight * hard


def make_distill_step(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    optimizer: Optional[AdamW] = None,
    temperature: float = 1.0,
    hard_weight: float = 0.5,
    device=None,
):
    """``step(draft_state, target_params, tokens, targets) -> (draft_state,
    loss)``: one distillation update of the draft against the frozen
    target, in place (as ``train.make_train_step``), both forwards through
    the flash core. Batches may be numpy arrays (uploaded to *device*, the
    card by default) or tensors there. Build ``draft_state`` with
    ``init_draft_state``. Returns ``(step, optimizer)``."""
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError("target and draft must share a vocabulary")
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    t_attn = _resolve_attention("flash", target_cfg.window)
    d_attn = _resolve_attention("flash", draft_cfg.window)

    def loss_fn(params, tokens, targets, t_logits):
        return distill_loss(draft_cfg, params, t_logits, tokens, targets,
                            temperature, hard_weight, attn_fn=d_attn)

    update = make_update_step(loss_fn, optimizer)

    def step(state: TrainState, target_params: Transformer, tokens,
             targets):
        tokens, targets = up(tokens, torch.int64), up(targets, torch.int64)
        with torch.no_grad():
            t_logits = model_lib.forward(target_params, tokens, target_cfg,
                                         t_attn)
        return update(state, tokens, targets, t_logits)

    return step, optimizer


def init_draft_state(generator: Optional[torch.Generator],
                     draft_cfg: ModelConfig, optimizer: AdamW,
                     init_params: Optional[Transformer] = None,
                     device=None) -> TrainState:
    """Fresh (from *generator*) or warm-started (e.g. ``truncated_draft``)
    distillation state. A warm start COPIES the tensors: the draft's
    in-place updates must never write into the target's own weights."""
    if init_params is not None:
        params = copy.deepcopy(init_params)
        if device is not None:
            params = params.to(resolve_device(device))
    else:
        params = model_lib.init_params(generator, draft_cfg,
                                       resolve_device(device))
    return state_from_params(params, optimizer)


def agreement_rate(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    target_params: Transformer,
    draft_params: Transformer,
    tokens,
) -> float:
    """Teacher-forced greedy agreement: fraction of positions where the
    draft's argmax equals the target's argmax given the same prefix. The
    per-position acceptance probability speculation sees; mean
    tokens/round is ~ (1 - a^(gamma+1)) / (1 - a) for agreement a.
    *tokens* (numpy or a tensor) run on the target's device, through the
    flash core."""
    device = target_params.embed.device
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.asarray(tokens))
    tokens = tokens.to(device=device, dtype=torch.int64)
    t = model_lib.forward(target_params, tokens, target_cfg,
                          _resolve_attention("flash", target_cfg.window))
    d = model_lib.forward(draft_params, tokens, draft_cfg,
                          _resolve_attention("flash", draft_cfg.window))
    return float((t.argmax(-1) == d.argmax(-1)).float().mean())
