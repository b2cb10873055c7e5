"""Single-card training step (port of ``kubetpu/jobs/train.py``).

loss -> gradients (``torch.autograd``) -> AdamW, on one card. The attention
core is the hand-written flash kernels (``attention="flash"``: forward, dQ
and dK/dV, through ``kubetpu_torch.ops.flash_attention``) or the plain
``dense_attention``; both honor ``cfg.window``.

The JAX package's default core, ``"ring"``, is a multi-device core
(sequence parallelism over a mesh), as are the mesh specs (``param_specs``,
``batch_spec``) and shardings: they wait for the multi-device slice, and
``attention="ring*"`` raises ``NotImplementedError`` here.

Where JAX returns a new state, the port updates the parameters and the
optimizer state in place (no second copy of the weights) and returns the
same ``TrainState``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device


@dataclasses.dataclass
class OptState:
    """AdamW state: the update count (a device int32 scalar, as optax keeps
    it) and the first and second moments, one per parameter, in the
    parameter's dtype."""
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """``optax.adamw`` with ``make_optimizer``'s trimmings, written out:
    optional ``clip_by_global_norm`` first, then Adam (bias-corrected,
    ``eps`` outside the square root), decoupled weight decay on every
    parameter, and the learning rate of the schedule at the update count.
    The schedule is computed in f32 on the device, as optax does."""

    def __init__(self, lr: float, weight_decay: float, warmup_steps: int,
                 decay_steps: Optional[int], min_lr_ratio: float,
                 clip_norm: Optional[float], b1: float, b2: float,
                 eps: float = 1e-8) -> None:
        if decay_steps is not None and decay_steps - warmup_steps <= 0:
            raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                             f"warmup_steps ({warmup_steps})")
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps
        self.min_lr_ratio = min_lr_ratio
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def _warmup(self, c: torch.Tensor) -> torch.Tensor:
        """``optax.linear_schedule(0, lr, warmup_steps)``."""
        if self.warmup_steps <= 0:
            return torch.zeros_like(c)
        frac = 1 - torch.clamp(c, 0, self.warmup_steps) / self.warmup_steps
        return (0.0 - self.lr) * frac + self.lr

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate (f32 scalar tensor) at update *count*."""
        c = count.float()
        if self.decay_steps is not None:
            # optax.warmup_cosine_decay_schedule: warmup, then cosine decay
            # to lr * min_lr_ratio over decay_steps - warmup_steps
            span = float(self.decay_steps - self.warmup_steps)
            alpha = 0.0 if self.lr == 0.0 else (
                self.lr * self.min_lr_ratio) / self.lr
            t = torch.clamp(c - self.warmup_steps, max=span)
            cosine = 0.5 * (1 + torch.cos(math.pi * t / span))
            decayed = self.lr * ((1 - alpha) * cosine + alpha)
            return torch.where(c < self.warmup_steps, self._warmup(c),
                               decayed)
        if self.warmup_steps:
            return self._warmup(c)
        return torch.full_like(c, self.lr)

    def init(self, params: List[torch.Tensor]) -> OptState:
        device = params[0].device
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
                for p in params],
            nu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
                for p in params])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor],
               ok: Optional[torch.Tensor] = None) -> None:
        """One update, in place on *params* and *state*. With *ok* (a device
        bool scalar) false, nothing changes: no host sync decides it."""
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: scale by max_norm / norm only when
            # the norm reaches max_norm
            g_norm = torch.sqrt(sum((g.float() * g.float()).sum()
                                    for g in grads))
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, (g / g_norm.to(g.dtype))
                                 * self.clip_norm) for g in grads]
        count_inc = state.count + 1
        lr = self.schedule(state.count)
        bc1 = 1 - self.b1 ** count_inc.float()
        bc2 = 1 - self.b2 ** count_inc.float()
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            mu_new = (1 - self.b1) * g + self.b1 * mu
            nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
            u = (mu_new / bc1.to(mu.dtype)) / (
                torch.sqrt(nu_new / bc2.to(nu.dtype)) + self.eps)
            u = u + self.weight_decay * p
            p_new = (p + u * (-lr).to(u.dtype)).to(p.dtype)
            if ok is not None:
                p_new = torch.where(ok, p_new, p)
                mu_new = torch.where(ok, mu_new, mu)
                nu_new = torch.where(ok, nu_new, nu)
            p.copy_(p_new)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
        state.count = (count_inc if ok is None
                       else torch.where(ok, count_inc, state.count))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 0, decay_steps: Optional[int] = None,
                   min_lr_ratio: float = 0.1, clip_norm: Optional[float] = None,
                   b1: float = 0.9, b2: float = 0.95) -> AdamW:
    """AdamW with the standard LLM pretraining trimmings, all optional:
    linear warmup -> cosine decay to ``min_lr_ratio * lr`` (when
    ``decay_steps`` is given; warmup alone holds the peak after warmup),
    and global-norm gradient clipping before the AdamW update."""
    return AdamW(lr, weight_decay, warmup_steps, decay_steps, min_lr_ratio,
                 clip_norm, b1, b2)


@dataclasses.dataclass
class TrainState:
    params: Transformer
    opt_state: OptState
    step: int = 0


def state_from_params(params: Transformer, optimizer: AdamW) -> TrainState:
    """A fresh ``TrainState`` training *params* (gradients turned on for
    every parameter; the serving legs stay gradient-free under
    ``torch.no_grad``)."""
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(list(params.parameters())))


def init_state(generator: torch.Generator, cfg: ModelConfig,
               optimizer: Optional[AdamW] = None, device=None):
    """-> (TrainState, optimizer): random weights from *generator* (which
    lives on *device*, the card by default) and a zero optimizer state."""
    optimizer = optimizer or make_optimizer()
    params = model_lib.init_params(generator, cfg, resolve_device(device))
    return state_from_params(params, optimizer), optimizer


def make_update_step(loss_fn, optimizer: AdamW, accum_steps: int = 1,
                     skip_nonfinite: bool = False):
    """The train-step body: value and gradients of ``loss_fn(params,
    *batch)``, then the optimizer. Returns ``step(state, *batch) -> (state,
    loss)`` with the loss a device f32 scalar.

    ``accum_steps > 1`` splits the batch into that many equal microbatches
    along axis 0 and sums their gradients in f32: the update sees the mean
    of the microbatch means, the full batch's mean for an unweighted loss.
    ``skip_nonfinite``: when the loss or any gradient is not finite, the
    parameters and the optimizer state stay as they were (decided on the
    device) and the step counter still advances."""

    def grads_of(params, batch):
        loss = loss_fn(params, *batch)
        leaves = list(params.parameters())
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state: TrainState, *batch):
        params = state.params
        leaves = list(params.parameters())
        if accum_steps <= 1:
            loss, grads = grads_of(params, batch)
        else:
            b = batch[0].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch size {b} not divisible by "
                                 f"accum_steps {accum_steps}")
            micro = b // accum_steps
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves]
            for i in range(accum_steps):
                chunk = tuple(x[i * micro:(i + 1) * micro] for x in batch)
                l, g = grads_of(params, chunk)
                loss = loss + l
                for acc, gi in zip(grad_sum, g):
                    acc.add_(gi.float())
            loss = loss / accum_steps
            grads = [(g / accum_steps).to(p.dtype)
                     for p, g in zip(leaves, grad_sum)]
        ok = None
        if skip_nonfinite:
            ok = torch.isfinite(loss)
            for g in grads:
                ok = ok & torch.isfinite(g).all()
        optimizer.update(list(grads), state.opt_state, leaves, ok)
        state.step += 1
        return state, loss

    return train_step


def _resolve_attention(attention: str, window: int = 0):
    """The attention core: 'flash' (the CUDA flash kernels through
    ``flash_attention``; their plain versions for CPU tensors) or 'dense'
    (``dense_attention``), both banded by ``window``."""
    if attention.startswith("ring"):
        raise NotImplementedError(
            f"attention={attention!r} is a multi-device core (ring attention "
            "over a sequence-parallel mesh); it waits for the multi-device "
            "slice (ROADMAP.md, queue 1, item 11)")
    if attention == "flash":
        from kubetpu_torch.ops.flash_attention import flash_attention

        return partial(flash_attention, causal=True, window=window)
    if attention == "dense":
        return partial(model_lib.dense_attention, causal=True, window=window)
    raise ValueError(f"unknown attention {attention!r}")


def _uploader(device: torch.device):
    def up(x, dtype=None):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        return t.to(device=device, dtype=dtype, non_blocking=True)

    return up


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    attention: str = "flash", accum_steps: int = 1,
                    skip_nonfinite: bool = False, weighted: bool = False,
                    device=None):
    """The full training step on one card: loss -> gradients -> AdamW.

    Pass the optimizer returned by ``init_state``. ``attention``: 'flash'
    (default) or 'dense'. ``weighted=True`` makes the step ``(state,
    tokens, targets, weights)`` with per-position loss weights (the
    packed-batch path). Batches may be numpy arrays (uploaded to *device*,
    the card by default) or tensors already there."""
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = _resolve_attention(attention, cfg.window)

    def loss_fn(params, tokens, targets, weights=None):
        return model_lib.next_token_loss(params, tokens, targets, cfg,
                                         attn_fn, weights=weights)

    step = make_update_step(loss_fn, optimizer, accum_steps=accum_steps,
                            skip_nonfinite=skip_nonfinite)

    def train_step(state: TrainState, tokens, targets, *weights):
        if len(weights) != int(weighted):
            raise TypeError(f"weighted={weighted}: the step takes "
                            f"{2 + int(weighted)} batch arrays")
        batch = (up(tokens, torch.int64), up(targets, torch.int64),
                 *(up(w, torch.float32) for w in weights))
        return step(state, *batch)

    return train_step


def make_eval_step(cfg: ModelConfig, attention: str = "flash", device=None):
    """``eval_step(params, tokens, targets) -> loss`` without gradients,
    through the same attention core as training, so that it measures the
    training objective (a windowed config evaluates banded)."""
    up = _uploader(resolve_device(device))
    attn_fn = _resolve_attention(attention, cfg.window)

    @torch.no_grad()
    def eval_step(params, tokens, targets):
        return model_lib.next_token_loss(params, up(tokens, torch.int64),
                                         up(targets, torch.int64), cfg,
                                         attn_fn)

    return eval_step
