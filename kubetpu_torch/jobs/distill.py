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

Over a mesh (``make_distill_step(..., mesh=)``) target and draft are shards
(``train.init_state(..., mesh=)``, ``train.shard_model``): the batch goes
on dp and sp (the attention core is then the flash ring), both models run
tensor-parallel, the teacher's logits are gathered whole over tp, the
draft's vocab shards are gathered through ``gather_vocab`` (a gather whose
backward is the rank's slice) so the soft cross-entropy sees the whole
vocabulary, and the draft's gradients go through ``train.GradSync``.
"""

from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs import train as train_lib
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


def _position_losses(d_logits, target_logits, targets, temperature: float,
                     hard_weight: float) -> torch.Tensor:
    """Each position's soft CE against the teacher's logits (times T^2)
    plus ``hard_weight`` x its data CE, from whole-vocabulary logits."""
    d_logits = d_logits.float()
    t_soft = torch.softmax(target_logits.float() / temperature, dim=-1)
    d_logsoft = torch.log_softmax(d_logits / temperature, dim=-1)
    soft = -(t_soft * d_logsoft).sum(dim=-1) * temperature ** 2
    # hard CE from the SAME logits (one draft forward per step, not two)
    logp = torch.log_softmax(d_logits, dim=-1)
    hard = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return soft + hard_weight * hard


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
    d_logits = _draft_logits(draft_cfg, draft_params, tokens, attn_fn)
    return _position_losses(d_logits, target_logits, targets, temperature,
                            hard_weight).mean()


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        return col.all_gather(x, group, "tp_logits", dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


def gather_vocab(x: torch.Tensor, group, index: int) -> torch.Tensor:
    """A rank's vocab shard (..., V/tp) gathered into the whole row over
    the tp *group* (this rank its *index*-th member); the gradient of the
    whole row comes back as the rank's slice of it."""
    if col.group_size(group) == 1:
        return x
    return _GatherVocab.apply(x, group, index)


def distill_mesh_parts(target_cfg: ModelConfig, draft_cfg: ModelConfig,
                       temperature: float, hard_weight: float, mesh,
                       attention: str):
    """(teacher_logits, loss_fn, sync) of the sharded distillation step:
    the teacher's whole-vocabulary logits at this rank's block (rows on
    the data axes, positions on sp), the draft's loss there (its hidden
    states behind ``copy_to``, its vocab shards gathered by
    ``gather_vocab``), the mean over the global batch, and the draft's
    ``GradSync``."""
    groups = col.groups_of(mesh)
    tp = groups.over("tp")
    tp_index = col.axis_index(mesh, "tp")
    sp_index = col.axis_index(mesh, "sp")
    data = groups.over(*train_lib.DATA_SP)
    t_attn = _resolve_attention(attention, target_cfg.window, mesh)
    d_attn = _resolve_attention(attention, draft_cfg.window, mesh)

    def hidden(cfg, params, tokens, attn_fn):
        positions = train_lib._positions(sp_index, tokens.shape[1],
                                         tokens.device)
        x, _aux = model_lib.run_blocks(
            cfg, attn_fn, positions, params.embed[tokens], params.blocks,
            body=partial(model_lib._block_output,
                         shard=train_lib.step_shard(cfg, groups)))
        x = model_lib.rms_norm(x, params.ln_f)
        return torch.einsum("bsd,dv->bsv", col.copy_to(x, tp), params.head)

    @torch.no_grad()
    def teacher_logits(target_params, tokens):
        return col.all_gather(hidden(target_cfg, target_params,
                                     train_lib.local_batch(tokens, mesh),
                                     t_attn).contiguous(), tp, "tp_logits",
                              dim=-1)

    def loss_fn(params, tokens, targets, t_logits):
        tokens = train_lib.local_batch(tokens, mesh)
        targets = train_lib.local_batch(targets, mesh)
        d_logits = gather_vocab(hidden(draft_cfg, params, tokens, d_attn),
                                tp, tp_index)
        total = _position_losses(d_logits, t_logits, targets, temperature,
                                 hard_weight).sum()
        return col.reduce_from(total, data, "dp") / (
            targets.numel() * col.group_size(data))

    return teacher_logits, loss_fn, train_lib.grad_sync(draft_cfg, groups)


def make_distill_step(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    optimizer: Optional[AdamW] = None,
    temperature: float = 1.0,
    hard_weight: float = 0.5,
    device=None,
    mesh=None,
):
    """``step(draft_state, target_params, tokens, targets) -> (draft_state,
    loss)``: one distillation update of the draft against the frozen
    target, in place (as ``train.make_train_step``), both forwards through
    the flash core. Batches may be numpy arrays (uploaded to *device*, the
    card by default) or tensors there. Build ``draft_state`` with
    ``init_draft_state``. Returns ``(step, optimizer)``. With *mesh* every
    rank passes the GLOBAL batch, its shard of the target and
    ``train.init_state(..., mesh=)``'s draft state; the core is the flash
    ring when sp > 1 (``distill_mesh_parts``)."""
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError("target and draft must share a vocabulary")
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    if mesh is None:
        t_attn = _resolve_attention("flash", target_cfg.window)
        d_attn = _resolve_attention("flash", draft_cfg.window)

        def loss_fn(params, tokens, targets, t_logits):
            return distill_loss(draft_cfg, params, t_logits, tokens,
                                targets, temperature, hard_weight,
                                attn_fn=d_attn)

        def teacher(target_params, tokens):
            return model_lib.forward(target_params, tokens, target_cfg,
                                     t_attn)
        sync = None
    else:
        for cfg in (target_cfg, draft_cfg):
            train_lib.check_mesh(cfg, mesh)
        attention = ("ring_flash" if col.axis_size(mesh, "sp") > 1
                     else "flash")
        teacher, loss_fn, sync = distill_mesh_parts(
            target_cfg, draft_cfg, temperature, hard_weight, mesh, attention)

    update = make_update_step(loss_fn, optimizer, sync=sync)

    def step(state: TrainState, target_params: Transformer, tokens,
             targets):
        tokens, targets = up(tokens, torch.int64), up(targets, torch.int64)
        if mesh is not None:
            target_params = train_lib.shard_model(target_params, target_cfg,
                                                  mesh)
        with torch.no_grad():
            t_logits = teacher(target_params, tokens)
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
