"""Flagship model: a decoder-only transformer (port of
``kubetpu/jobs/model.py``).

Llama-style block: RMSNorm, rotary embeddings (with the optional Llama-3.1
frequency warp), grouped-query attention and a SwiGLU MLP. Weights keep the
JAX package's layouts (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``,
``head`` is ``(d, V)``) so a parameter tree converts one leaf at a time
(``convert.params_from_numpy``). Where the JAX package stacks the layers on a
leading axis and runs one ``lax.scan``, the port holds one ``Block`` module
per layer and loops over them in Python.

Training: ``forward_hidden`` rematerializes each block under
``cfg.remat`` (``torch.utils.checkpoint``), and ``next_token_loss`` ends in
the shared loss tail (``lm_loss_tail``: materialized or chunked logits,
label smoothing, z-loss, per-position weights). ``forward`` alone runs
without gradients.

Mixture-of-experts blocks are not ported yet: a config with
``n_experts > 0`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

# attention core signature: (q, k, v) with shapes (B, S, H, D) -> (B, S, H, D)
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

NEG_INF = -1e30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no ``device`` and no CUDA this raises — the port never
    drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32
    # recompute each block's forward during backward (torch.utils.checkpoint)
    remat: bool = False
    # what remat saves: "full" saves nothing inside a block; "dots" saves
    # every matmul output and recomputes only the elementwise and norm ops
    remat_policy: str = "full"
    # 0 = materialize the (B, S, V) logits at the loss; > 0 = stream the LM
    # head and cross-entropy over sequence chunks of this size (must divide S)
    loss_chunk: int = 0
    # uniform label smoothing mass: (1-e)*nll - e*mean(logp) (0 = off)
    label_smoothing: float = 0.0
    # PaLM-style z-loss coefficient: + z * logsumexp(logits)^2 (0 = off)
    z_loss: float = 0.0
    # sliding-window attention: each position sees the previous `window`
    # positions including itself (0 = full causal)
    window: int = 0
    # Llama-3.1 RoPE warp: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings) or None
    rope_llama3_scaling: Optional[tuple] = None
    # grouped-query attention: K/V heads (0 = n_heads)
    n_kv_heads: int = 0
    # mixture-of-experts blocks: not ported yet (must stay 0)
    n_experts: int = 0

    def __post_init__(self):
        if self.n_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts blocks (n_experts > 0) are not ported "
                "to kubetpu_torch yet")
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got {self.loss_chunk}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(
                f"label_smoothing must be in [0, 1), got {self.label_smoothing}")
        if self.z_loss < 0:
            raise ValueError(f"z_loss must be >= 0, got {self.z_loss}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.rope_llama3_scaling is not None:
            s = self.rope_llama3_scaling
            if (not isinstance(s, tuple) or len(s) != 4
                    or not all(isinstance(x, (int, float)) for x in s)):
                raise ValueError(
                    "rope_llama3_scaling must be a (factor, low_freq_factor, "
                    "high_freq_factor, original_max_position_embeddings) "
                    f"tuple, got {s!r}")
            if s[1] == s[2]:
                raise ValueError(
                    "rope_llama3_scaling low_freq_factor == high_freq_factor "
                    "divides by zero in the smoothing band")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must divide "
                f"n_heads ({self.n_heads})")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One transformer layer's weights, in the JAX package's layouts."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        d, h, hd, f, kv = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                           cfg.kv_heads)
        self.ln1 = _param((d,), cfg, device)
        self.ln2 = _param((d,), cfg, device)
        self.wq = _param((d, h, hd), cfg, device)
        self.wk = _param((d, kv, hd), cfg, device)
        self.wv = _param((d, kv, hd), cfg, device)
        self.wo = _param((h, hd, d), cfg, device)
        self.w_gate = _param((d, f), cfg, device)
        self.w_up = _param((d, f), cfg, device)
        self.w_down = _param((f, d), cfg, device)


class Transformer(nn.Module):
    """The whole model: ``embed (V, d)``, one ``Block`` per layer,
    ``ln_f (d,)`` and ``head (d, V)``. Constructed with uninitialized
    weights; ``init_params`` or ``convert.params_from_numpy`` fill them."""

    def __init__(self, cfg: ModelConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg, device)
        self.blocks = nn.ModuleList(
            [Block(cfg, device) for _ in range(cfg.n_layers)])
        self.ln_f = _param((cfg.d_model,), cfg, device)
        self.head = _param((cfg.d_model, cfg.vocab), cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Transformer:
    """Random weights with ``kubetpu.jobs.model.init_params``'s shapes and
    scale rule (normal draws in ``cfg.dtype`` times ``d**-0.5``,
    ``(H*hd)**-0.5`` for ``wo``, ``d_ff**-0.5`` for ``w_down``; norms at 1),
    drawn from *generator*, which must live on *device*. The numbers differ
    from ``jax.random``'s; tests that compare the two packages convert one
    tree with ``params_from_numpy`` instead."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, weights "
                         f"on {device}")
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    model = Transformer(cfg, device)
    scale = d ** -0.5

    def normal_(p: torch.Tensor, s: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device,
                            dtype=cfg.dtype) * s)

    with torch.no_grad():
        for blk in model.blocks:
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
            normal_(blk.wq, scale)
            normal_(blk.wk, scale)
            normal_(blk.wv, scale)
            normal_(blk.wo, (h * hd) ** -0.5)
            normal_(blk.w_gate, scale)
            normal_(blk.w_up, scale)
            normal_(blk.w_down, f ** -0.5)
        normal_(model.embed, scale)
        model.ln_f.fill_(1.0)
        normal_(model.head, scale)
    return model


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         llama3_scaling=None) -> torch.Tensor:
    """Rotary position embedding. x: (B, S, H, D); positions: (S,) or
    (B, S). ``llama3_scaling`` is the Llama-3.1 frequency warp (long
    wavelengths divide by *factor*, short ones pass, the band between
    interpolates)."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=x.device) / d_half)
    if llama3_scaling is not None:
        factor, lo, hi, old_len = llama3_scaling
        wavelen = 2.0 * math.pi / freqs
        scaled = torch.where(wavelen > old_len / lo, freqs / factor, freqs)
        smooth = (old_len / wavelen - lo) / (hi - lo)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= old_len / hi) & (wavelen <= old_len / lo)
        freqs = torch.where(medium, smoothed, scaled)
    angles = positions.float()[..., None] * freqs   # (..., S, d_half)
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., H_kv, D) -> (..., H_kv * n_rep, D); identity for MHA."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Reference attention core, (B, S, H, D) in and out: f32 scores and
    softmax, causal (optionally banded to ``window``) or bidirectional."""
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal attention")
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s = q.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        if window > 0:
            pos = torch.arange(s, device=q.device)
            mask &= pos[:, None] - pos[None, :] < window
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def default_attn_fn(cfg: ModelConfig) -> AttnFn:
    """The default attention core for a config (banded when windowed)."""
    return partial(dense_attention, causal=True, window=cfg.window)


def _mlp(cfg: ModelConfig, h: torch.Tensor, layer: Block) -> torch.Tensor:
    """The dense SwiGLU branch: silu(h W_gate) * (h W_up) W_down."""
    gate = torch.nn.functional.silu(h @ layer.w_gate)
    return (gate * (h @ layer.w_up)) @ layer.w_down


def _block_with_aux(cfg: ModelConfig, attn_fn: AttnFn,
                    positions: torch.Tensor, x: torch.Tensor, layer: Block):
    """One transformer block -> (x, aux, k, v): the MoE aux term (0.0 for
    the dense blocks ported here) and the rotary-embedded K/V at kv-head
    width, which is what a KV cache stores."""
    h = rms_norm(x, layer.ln1)
    q = torch.einsum("bsd,dhk->bshk", h, layer.wq)
    k = torch.einsum("bsd,dhk->bshk", h, layer.wk)
    v = torch.einsum("bsd,dhk->bshk", h, layer.wv)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    n_rep = cfg.n_heads // cfg.kv_heads
    attn = attn_fn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))
    x = x + torch.einsum("bshk,hkd->bsd", attn, layer.wo)
    x = x + _mlp(cfg, rms_norm(x, layer.ln2), layer)
    return x, 0.0, k, v


def _block_output(cfg, attn_fn, positions, x, layer):
    return _block_with_aux(cfg, attn_fn, positions, x, layer)[0]


def _remat_context_fn(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``: the
    default (save nothing inside the block) for "full"; for "dots", a
    selective-checkpoint policy that saves every matmul output and
    recomputes the rest (the counterpart of XLA's
    ``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat_policy == "full":
        return noop_context_fn
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError as e:
        raise NotImplementedError(
            "remat_policy='dots' needs torch.utils.checkpoint's selective "
            "checkpointing (create_selective_checkpoint_contexts)") from e
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}

    def policy(_ctx, op, *_args, **_kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(create_selective_checkpoint_contexts, policy)


def forward_hidden(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, attn_fn: Optional[AttnFn] = None,
                   positions: Optional[torch.Tensor] = None):
    """The block stack without the LM head -> (final-norm hidden states
    (B, S, D), summed MoE aux term)."""
    if attn_fn is None:
        attn_fn = default_attn_fn(cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    x = params.embed[tokens]
    aux = 0.0
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.blocks:
        if remat:
            # the dense blocks' aux term is 0.0: only x crosses the boundary
            x = checkpoint(_block_output, cfg, attn_fn, positions, x, layer,
                           use_reentrant=False,
                           context_fn=_remat_context_fn(cfg))
        else:
            x, a, _k, _v = _block_with_aux(cfg, attn_fn, positions, x, layer)
            aux = aux + a
    return rms_norm(x, params.ln_f), aux


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[AttnFn] = None,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token logits: tokens (B, S) int -> (B, S, V)."""
    x, _aux = forward_hidden(params, tokens, cfg, attn_fn, positions)
    return torch.einsum("bsd,dv->bsv", x, params.head)


def _position_losses(logits, targets, label_smoothing: float,
                     z_loss: float) -> torch.Tensor:
    """Per-position loss in f32 from raw logits, the formula both loss tails
    share: cross-entropy, label-smoothed as ``(1-e)*nll - e*mean(logp)``,
    plus the z-loss ``z * logsumexp(logits)^2``."""
    f32 = logits.float()
    lse = torch.logsumexp(f32, dim=-1)
    logp = f32 - lse[..., None]
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = ((1.0 - label_smoothing) * nll
               - label_smoothing * logp.mean(dim=-1))
    if z_loss > 0:
        nll = nll + z_loss * lse.square()
    return nll


def token_cross_entropy(logits, targets, weights=None,
                        label_smoothing: float = 0.0,
                        z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross-entropy in f32: the unweighted mean, or with
    *weights* (targets' shape) the weighted mean over nonzero weights."""
    nll = _position_losses(logits, targets, label_smoothing, z_loss)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _chunk_loss(xi, head, ti, wi, label_smoothing, z_loss):
    logits = torch.einsum("bcd,dv->bcv", xi, head)
    nll = _position_losses(logits, ti, label_smoothing, z_loss)
    return (nll * wi).sum(), wi.sum()


def chunked_token_cross_entropy(x, head, targets, chunk: int, weights=None,
                                label_smoothing: float = 0.0,
                                z_loss: float = 0.0) -> torch.Tensor:
    """Cross-entropy from hidden states (B, S, D) without the full
    (B, S, V) logits: one (B, chunk, V) head product and log-softmax per
    sequence chunk, each checkpointed so that backward recomputes one
    chunk's logits at a time. ``chunk`` must divide S."""
    b, s, _d = x.shape
    if s % chunk:
        raise ValueError(f"chunk ({chunk}) must divide sequence length ({s})")
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weights = weights.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk],
                weights[:, c0:c0 + chunk], label_smoothing, z_loss)
        if torch.is_grad_enabled():
            n, w = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            n, w = _chunk_loss(*args)
        nll_sum, w_sum = nll_sum + n, w_sum + w
    return nll_sum / torch.clamp(w_sum, min=1.0)


def lm_loss_tail(x, head, targets, cfg: ModelConfig,
                 weights=None) -> torch.Tensor:
    """The loss tail: final-norm hidden states -> mean cross-entropy, as one
    materialized (B, S, V) logits tensor or the chunked stream
    (``cfg.loss_chunk``), with the config's label smoothing and z-loss."""
    if cfg.loss_chunk > 0:
        return chunked_token_cross_entropy(
            x, head, targets, cfg.loss_chunk, weights,
            label_smoothing=cfg.label_smoothing, z_loss=cfg.z_loss)
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return token_cross_entropy(logits, targets, weights,
                               label_smoothing=cfg.label_smoothing,
                               z_loss=cfg.z_loss)


def next_token_loss(params: Transformer, tokens: torch.Tensor,
                    targets: torch.Tensor, cfg: ModelConfig,
                    attn_fn: Optional[AttnFn] = None,
                    positions: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean causal LM cross-entropy, differentiable (it does not pass
    through the gradient-free ``forward``). ``targets`` is ``tokens``
    shifted by one (the data pipeline's job); ``weights`` (B, S) masks
    positions out of the mean (pad positions of packed batches)."""
    x, _aux = forward_hidden(params, tokens, cfg, attn_fn, positions)
    return lm_loss_tail(x, params.head, targets, cfg, weights)
