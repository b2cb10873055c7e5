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

Over a mesh the factor that carries a tp-sharded base axis is cut on tp
(``lora_param_specs``, ``shard_lora``) and the rank axis stays whole, so
the merge of a rank's factors lands on its shard of the base
(``train.shard_model``): ``make_lora_train_step(..., mesh=)`` runs the
sharded step's loss on the merged shards and sums each factor's gradient
over the data axes, and over tp where the factor is replicated there (its
gradient is then the rank's heads' part).
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.quant import require_unquantized
from kubetpu_torch.jobs.train import (AdamW, GradSync, TrainState,
                                      _mesh_loss_fn, _resolve_attention,
                                      _take, _trained_leaves, _uploader,
                                      check_mesh, make_optimizer,
                                      make_update_step)

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

# per-target (A spec, B spec): the factor that carries the base weight's
# tp-sharded axis keeps it on tp; the rank axis is always whole
_FACTOR_SPECS = {
    "wq": ((None, None, None), (None, None, "tp", None)),
    "wk": ((None, None, None), (None, None, "tp", None)),
    "wv": ((None, None, None), (None, None, "tp", None)),
    "wo": ((None, "tp", None, None), (None, None, None)),
    "w_gate": ((None, None, None), (None, None, "tp")),
    "w_up": ((None, None, None), (None, None, "tp")),
    "w_down": ((None, "tp", None), (None, None, None)),
}


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


def lora_param_specs(cfg: ModelConfig, lcfg: LoraConfig) -> dict:
    """The axis each dimension of each factor shards on (the JAX package's
    ``PartitionSpec`` tuples, the layer axis first), consistent with
    ``train.param_specs``: whichever base axis is on tp stays on tp in the
    factor that carries it; the rank axis is replicated."""
    _check_targets(cfg, lcfg)
    blocks = {}
    for t in lcfg.targets:
        blocks[f"{t}_a"], blocks[f"{t}_b"] = _FACTOR_SPECS[t]
    return {"blocks": blocks}


def _leaf_spec(key: str) -> tuple:
    target, factor = key.rsplit("_", 1)
    return _FACTOR_SPECS[target][0 if factor == "a" else 1]


def shard_lora(tree: dict, mesh, stacked: bool = False) -> dict:
    """This rank's slices of an adapter tree of tensors by
    ``lora_param_specs`` (a *stacked* tree's leaves lead with the adapter
    axis (N, L, ...)), as contiguous copies."""
    lead = (None,) if stacked else ()
    return {"blocks": {
        k: _take(v, lead + _leaf_spec(k), mesh).contiguous().clone()
        for k, v in tree["blocks"].items()}}


def lora_grad_sync(lora: dict, mesh) -> GradSync:
    """The ``GradSync`` of a rank's adapter slices (leaves in sorted key
    order): every factor's gradient summed over the data axes and sp, and
    over tp for a factor replicated there (each tp rank computed its
    heads' part); the norm counts a tp-sharded factor's squares over tp."""
    groups = col.groups_of(mesh)
    data_sp = tuple(a for a in ("dcn", "dp", "sp")
                    if a in mesh.mesh_dim_names)
    reduce_axes, shard_axes = [], []
    for k in sorted(lora["blocks"]):
        on_tp = "tp" in _leaf_spec(k)
        reduce_axes.append(data_sp + (() if on_tp else ("tp",)))
        shard_axes.append(("tp",) if on_tp else ())
    return GradSync(groups, reduce_axes, shard_axes)


def lora_param_count(lora: dict) -> int:
    return sum(v.numel() for v in lora["blocks"].values())


def init_lora_state(generator: torch.Generator, cfg: ModelConfig,
                    lcfg: LoraConfig, optimizer: Optional[AdamW] = None,
                    device=None, mesh=None):
    """-> (TrainState over the adapters only, optimizer): fresh adapters
    from *generator* with gradients on, and a zero AdamW state for them.
    The base model is not part of the state: pass it to the step. With
    *mesh* every rank draws the whole adapter from the same seed and keeps
    its slices (``shard_lora``)."""
    optimizer = optimizer or make_optimizer()
    lora = init_lora_params(generator, cfg, lcfg, device)
    if mesh is not None:
        lora = shard_lora(lora, mesh)
    for v in lora["blocks"].values():
        v.requires_grad_(True)
    return TrainState(lora, optimizer.init(_trained_leaves(lora))), optimizer


def make_lora_train_step(cfg: ModelConfig, lcfg: LoraConfig,
                         optimizer: Optional[AdamW] = None,
                         attention: str = "flash", accum_steps: int = 1,
                         skip_nonfinite: bool = False, device=None,
                         mesh=None):
    """``step(state, base, tokens, targets) -> (state, loss)``: the loss of
    the merged weights, gradients into A and B only, AdamW on the adapter
    state in place. *base* is frozen (``requires_grad_(False)``) and never
    written. ``attention``: 'flash' (default: the flash kernels on the
    card) or 'dense'; on a mesh also 'ring' or 'ring_flash' (the flash
    kernels in every ring step). Batches may be numpy arrays (uploaded to
    *device*, the card by default) or tensors already there.

    With *mesh* every rank passes its ``train.shard_model`` shard of the
    base, ``init_lora_state(..., mesh=)``'s state and the GLOBAL batch;
    the loss is the sharded step's on this rank's block
    (``train.local_batch``) and gradients meet in ``lora_grad_sync``."""
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
    attn_fn = _resolve_attention(attention, cfg.window, mesh)
    sync = None
    if mesh is None:
        def loss_fn(lora, base, tokens, targets):
            return model_lib.next_token_loss(_merged_view(base, lora, lcfg),
                                             tokens, targets, cfg, attn_fn)
    else:
        check_mesh(cfg, mesh)
        mesh_loss = _mesh_loss_fn(cfg, attn_fn, col.groups_of(mesh))
        specs = lora_param_specs(cfg, lcfg)
        sync = lora_grad_sync(specs, mesh)

        def loss_fn(lora, base, tokens, targets):
            return mesh_loss(_merged_view(base, lora, lcfg), tokens,
                             targets)

    inner = make_update_step(loss_fn, optimizer,
                             skip_nonfinite=skip_nonfinite, sync=sync)

    def step(state: TrainState, base: Transformer, tokens, targets):
        require_unquantized(base, "the LoRA train step")
        base.requires_grad_(False)
        return inner(state, base, up(tokens, torch.int64),
                     up(targets, torch.int64))

    return step
