"""LoRA fine-tuning: low-rank adapters over the flagship model (port of
``kubetpu/jobs/lora.py``).

An adapter is a tree ``{"blocks": {"<target>_a": (L, in..., r),
"<target>_b": (L, r, out...)}}`` of tensors, stacked on the leading layer
axis like the JAX package's blocks: its keys, shapes and layer-major layout
are the reference's, because ``multi_lora.adapter_fingerprint`` and the
wire codec (``router.adapters``) hash and ship exactly that layout.

Fine-tuning is functional: the base ``Transformer`` is an ordinary argument
of the step that is never updated (``requires_grad_(False)``), the
effective weights ``W + (alpha/r) * A @ B`` are built as tensors inside the
step (``_merged_view``: gradients flow through the merge into A and B),
and only the adapter leaves carry gradients and AdamW state. The step is
``train.make_update_step`` over the adapter leaves, so the non-finite guard
applies unchanged.

``merge_lora`` is the export path: a new ``Transformer`` with the adapter
folded in, the base left as it was; the servers decode it with no
inference-time cost.

Not ported yet: ``lora_param_specs`` and the sharded LoRA step (the last
multi-device slice, ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.quant import require_unquantized
from kubetpu_torch.jobs.train import (AdamW, TrainState, _resolve_attention,
                                      _trained_leaves, _uploader,
                                      make_optimizer, make_update_step)

# per-target factor layout: A carries the base weight's IN dims, B its OUT
# dims, so delta = A @ B lands in the base's exact shape (layer axis
# batched)
_MERGE_EINSUM = {
    "wq": "ldr,lrhk->ldhk",
    "wk": "ldr,lrhk->ldhk",
    "wv": "ldr,lrhk->ldhk",
    "wo": "lhkr,lrd->lhkd",
    "w_gate": "ldr,lrf->ldf",
    "w_up": "ldr,lrf->ldf",
    "w_down": "lfr,lrd->lfd",
}
_MLP_TARGETS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """rank/alpha and which base weights get adapters. The default targets
    are the attention projections; MLP targets are valid for dense models
    only (expert weights carry an axis the rank-r factorization does not
    model)."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        unknown = [t for t in self.targets if t not in _MERGE_EINSUM]
        if unknown:
            raise ValueError(
                f"unknown LoRA target(s) {unknown}; choose from "
                f"{sorted(_MERGE_EINSUM)}")
        if not self.targets:
            raise ValueError("LoRA needs at least one target")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _check_targets(cfg: ModelConfig, lcfg: LoraConfig) -> None:
    """The reference's MoE guard: MLP targets have no adapter layout over
    the expert axis."""
    if cfg.n_experts > 0 and any(t in _MLP_TARGETS for t in lcfg.targets):
        raise ValueError(
            "MLP LoRA targets are unsupported for MoE configs (expert-axis "
            "weights); restrict targets to the attention projections")


def _factor_shapes(cfg: ModelConfig, target: str, r: int):
    """(A shape, B shape) for one target, mirroring the base layouts."""
    L, d, h, hd, f = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                      cfg.d_ff)
    if target in ("wq", "wk", "wv"):
        heads = h if target == "wq" else cfg.kv_heads
        return (L, d, r), (L, r, heads, hd)
    if target == "wo":
        return (L, h, hd, r), (L, r, d)
    if target in ("w_gate", "w_up"):
        return (L, d, r), (L, r, f)
    return (L, f, r), (L, r, d)  # w_down


def init_lora_params(generator: torch.Generator, cfg: ModelConfig,
                     lcfg: LoraConfig, device=None) -> dict:
    """A ~ N(0, 1/in_dim), B = 0, in ``cfg.dtype`` on *device* (the card by
    default), drawn from *generator* (which must live there): the delta
    starts at exactly zero, so step 0 of fine-tuning reproduces the base
    model bit for bit. The draws differ from ``jax.random``'s; tests carry
    a JAX tree across with ``convert.lora_from_numpy``."""
    _check_targets(cfg, lcfg)
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, adapters "
                         f"on {device}")
    blocks = {}
    for t in lcfg.targets:
        a_shape, b_shape = _factor_shapes(cfg, t, lcfg.rank)
        in_dim = 1
        for s in a_shape[1:-1]:
            in_dim *= s
        blocks[f"{t}_a"] = torch.randn(
            a_shape, generator=generator, device=device,
            dtype=cfg.dtype) * in_dim ** -0.5
        blocks[f"{t}_b"] = torch.zeros(b_shape, dtype=cfg.dtype,
                                       device=device)
    return {"blocks": blocks}


def _merged_view(base: Transformer, lora: dict, lcfg: LoraConfig):
    """The effective weights as a stand-in for *base*: the attributes
    ``forward_hidden`` and the loss read (``embed``, ``blocks``, ``ln_f``,
    ``head``), with every target ``W + scale * A @ B`` computed as a tensor
    (one einsum a target over all layers), so gradients reach A and B and
    the base's parameters stay untouched."""
    deltas = {}
    for t in lcfg.targets:
        a, b = lora["blocks"][f"{t}_a"], lora["blocks"][f"{t}_b"]
        deltas[t] = torch.einsum(_MERGE_EINSUM[t], a, b) * lcfg.scale
    blocks = []
    for i, blk in enumerate(base.blocks):
        leaves = {name: getattr(blk, name)
                  for name in model_lib.block_leaves(base.cfg)}
        for t, delta in deltas.items():
            leaves[t] = leaves[t] + delta[i].to(leaves[t].dtype)
        blocks.append(SimpleNamespace(**leaves))
    return SimpleNamespace(embed=base.embed, blocks=blocks, ln_f=base.ln_f,
                           head=base.head)


@torch.no_grad()
def merge_lora(base: Transformer, lora: dict,
               lcfg: LoraConfig) -> Transformer:
    """A new ``Transformer`` holding ``W + (alpha/r) * A @ B`` for every
    target (the export path; the servers decode it with no inference-time
    overhead). *base* is left as it was; an int8 base is refused."""
    require_unquantized(base, "merge_lora")
    merged = copy.deepcopy(base)
    view = _merged_view(base, lora, lcfg)
    for blk, src in zip(merged.blocks, view.blocks):
        for t in lcfg.targets:
            getattr(blk, t).copy_(getattr(src, t))
    return merged


def lora_param_count(lora: dict) -> int:
    return sum(v.numel() for v in lora["blocks"].values())


def init_lora_state(generator: torch.Generator, cfg: ModelConfig,
                    lcfg: LoraConfig, optimizer: Optional[AdamW] = None,
                    device=None):
    """-> (TrainState over the adapters only, optimizer): fresh adapters
    from *generator* with gradients on, and a zero AdamW state for them.
    The base model is not part of the state: pass it to the step."""
    optimizer = optimizer or make_optimizer()
    lora = init_lora_params(generator, cfg, lcfg, device)
    for v in lora["blocks"].values():
        v.requires_grad_(True)
    return TrainState(lora, optimizer.init(_trained_leaves(lora))), optimizer


def make_lora_train_step(cfg: ModelConfig, lcfg: LoraConfig,
                         optimizer: Optional[AdamW] = None,
                         attention: str = "flash", accum_steps: int = 1,
                         skip_nonfinite: bool = False, device=None):
    """``step(state, base, tokens, targets) -> (state, loss)``: the loss of
    the merged weights, gradients into A and B only, AdamW on the adapter
    state in place. *base* is frozen (``requires_grad_(False)``) and never
    written. ``attention``: 'flash' (default: the flash kernels on the
    card) or 'dense'. Batches may be numpy arrays (uploaded to *device*,
    the card by default) or tensors already there."""
    _check_targets(cfg, lcfg)
    if accum_steps > 1:
        # the base rides in the batch position of make_update_step, whose
        # accumulation would split it into microbatches; LoRA's activation
        # memory equals the base model's anyway, so shrink the batch
        raise NotImplementedError(
            "accum_steps > 1 with LoRA: use a smaller batch — the adapter "
            "state is tiny, activation memory matches the base model's")
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = _resolve_attention(attention, cfg.window)

    def loss_fn(lora, base, tokens, targets):
        return model_lib.next_token_loss(_merged_view(base, lora, lcfg),
                                         tokens, targets, cfg, attn_fn)

    inner = make_update_step(loss_fn, optimizer,
                             skip_nonfinite=skip_nonfinite)

    def step(state: TrainState, base: Transformer, tokens, targets):
        require_unquantized(base, "the LoRA train step")
        base.requires_grad_(False)
        return inner(state, base, up(tokens, torch.int64),
                     up(targets, torch.int64))

    return step
