"""The training step (port of ``kubetpu/jobs/train.py``), on one card or
sharded over a mesh.

loss -> gradients (``torch.autograd``) -> AdamW. The attention core is the
hand-written flash kernels (``attention="flash"``: forward, dQ and dK/dV,
through ``kubetpu_torch.ops.flash_attention``), the plain
``dense_attention``, or on a mesh the rings (``"ring"``, ``"ring_flash"``:
``ring_attention``); all honor ``cfg.window``. Mixture-of-experts configs
train with the load-balance term in the loss.

With ``mesh=`` (a ``meshjob`` DeviceMesh over dp, sp, tp, ep and dcn)
every rank runs its shard of the step: ``param_specs`` / ``batch_spec``
say which dimension shards on which axis, ``shard_model`` cuts a rank's
shard, the blocks run tensor-parallel through autograd-aware collectives
(``collectives``), a MoE block runs the rank's experts (``ep``; tokens are
replicated over ep, so the expert exchange is a sum) with its capacity
dispatch and load-balance term over the global batch, and the loss tail
is vocab-parallel. ``data.prefetch_to_mesh`` feeds the step each rank's
block ahead of time; ``pipeline`` adds the pp axis. ``init_shard`` draws a
rank's shard leaf by leaf (``draw_shard``), never the whole model; the
encoder, ViT, seq2seq and distillation steps build on the same pieces
(``sync_for``, ``sharded_loss_tail``, ``step_shard``).

Where JAX returns a new state, the port updates the parameters and the
optimizer state in place (no second copy of the weights) and returns the
same ``TrainState``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.model import (ModelConfig, Transformer,
                                      resolve_device, rms_norm)
from kubetpu_torch.jobs.quant import require_unquantized
from kubetpu_torch.jobs.ring_attention import make_ring_attention


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
               ok: Optional[torch.Tensor] = None,
               sq_norm=None) -> None:
        """One update, in place on *params* and *state*. With *ok* (a device
        bool scalar) false, nothing changes: no host sync decides it.
        *sq_norm* (``grads -> squared global norm``) replaces the local sum
        of squares where *grads* are one rank's shards of a sharded
        model."""
        if self.clip_norm is not None:
            # optax.clip_by_global_norm: scale by max_norm / norm only when
            # the norm reaches max_norm
            g_norm = torch.sqrt(
                sq_norm(grads) if sq_norm is not None
                else sum((g.float() * g.float()).sum() for g in grads))
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
    ``torch.no_grad``). An int8 model is refused: it has no gradient
    path."""
    require_unquantized(params, "training")
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params, optimizer.init(list(params.parameters())))


def init_state(generator: torch.Generator, cfg: ModelConfig,
               optimizer: Optional[AdamW] = None, device=None, mesh=None,
               pp: bool = False):
    """-> (TrainState, optimizer): random weights from *generator* (which
    lives on *device*, the card by default) and a zero optimizer state.
    With *mesh*, every rank draws the model leaf by leaf from the same seed
    and keeps its shard of each leaf (``init_shard``; *pp*: its pipeline
    stage's layers), so the shards are those of the one-card model of that
    seed and no rank ever holds the whole model."""
    optimizer = optimizer or make_optimizer()
    if mesh is not None:
        params = init_shard(generator, cfg, mesh, device, pp)
    else:
        params = model_lib.init_params(generator, cfg, resolve_device(device))
    return state_from_params(params, optimizer), optimizer


def _trained_leaves(params) -> List[torch.Tensor]:
    """The tensors a step trains: a model's parameters, or an adapter
    tree's leaves in sorted key order (the order of the optimizer state)."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return [params["blocks"][k] for k in sorted(params["blocks"])]


def make_update_step(loss_fn, optimizer: AdamW, accum_steps: int = 1,
                     skip_nonfinite: bool = False, sync=None):
    """The train-step body: value and gradients of ``loss_fn(params,
    *batch)``, then the optimizer. *params* is a ``Transformer`` or a LoRA
    adapter tree (``{"blocks": {leaf: tensor}}``). Returns ``step(state, *batch) -> (state,
    loss)`` with the loss a device f32 scalar.

    ``accum_steps > 1`` splits the batch into that many equal microbatches
    along axis 0 and sums their gradients in f32: the update sees the mean
    of the microbatch means, the full batch's mean for an unweighted loss.
    ``skip_nonfinite``: when the loss or any gradient is not finite, the
    parameters and the optimizer state stay as they were (decided on the
    device) and the step counter still advances. *sync* (a ``GradSync``,
    on a mesh) sums each rank's gradients over the ranks that share the
    leaf, gives the clip its global norm and makes the finite check
    global."""

    def grads_of(params, batch):
        loss = loss_fn(params, *batch)
        leaves = _trained_leaves(params)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state: TrainState, *batch):
        params = state.params
        leaves = _trained_leaves(params)
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
        if sync is not None:
            grads = sync.reduce(grads)
        ok = None
        if skip_nonfinite:
            ok = torch.isfinite(loss)
            for g in grads:
                ok = ok & torch.isfinite(g).all()
            if sync is not None:
                ok = sync.all_ok(ok)
        if sync is None:
            optimizer.update(list(grads), state.opt_state, leaves, ok)
        else:
            optimizer.update(list(grads), state.opt_state, leaves, ok,
                             sq_norm=sync.sq_norm)
        state.step += 1
        return state, loss

    return train_step


# ---------------------------------------------------------------------------
# The mesh: which dimension of each leaf and of the batch shards on which
# axis (the JAX package's param_specs / batch_spec), each rank's shard of a
# model, and the step over dp x sp x tp (x dcn). GSPMD inserts the
# collectives for the JAX package; here they are explicit and autograd-aware
# (collectives.py): column-parallel q/k/v and gate/up behind ``copy_to``,
# row-parallel wo and w_down into ``reduce_from``, and a vocab-parallel loss
# tail. Every collective of a step runs in the same order on every rank,
# also when remat replays a block's forward in the backward.
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, pp: bool = False) -> dict:
    """The axis each dimension of each leaf shards on, as the JAX
    package's ``PartitionSpec`` tuples (the blocks' leading layer axis
    included: ``"pp"`` under *pp*, else None): heads of wq/wk/wv/wo, the ff
    of w_gate/w_up/w_down and the head's vocab on tp; experts on ep."""
    L = "pp" if pp else None
    blocks = {"ln1": (L, None), "ln2": (L, None),
              "wq": (L, None, "tp", None), "wk": (L, None, "tp", None),
              "wv": (L, None, "tp", None), "wo": (L, "tp", None, None)}
    if cfg.n_experts > 0:
        blocks.update({"moe_router": (L, None, None),
                       "w_gate": (L, "ep", None, "tp"),
                       "w_up": (L, "ep", None, "tp"),
                       "w_down": (L, "ep", "tp", None)})
    else:
        blocks.update({"w_gate": (L, None, "tp"), "w_up": (L, None, "tp"),
                       "w_down": (L, "tp", None)})
    return {"embed": (None, None), "blocks": blocks, "ln_f": (None,),
            "head": (None, "tp")}


def batch_spec(mesh=None) -> tuple:
    """(B, S) tokens: the batch on the data axes (``dcn`` and ``dp`` on a
    multislice mesh: the only traffic between slices is the gradients'),
    the sequence on sp."""
    if mesh is not None and "dcn" in (mesh.mesh_dim_names or ()):
        return (("dcn", "dp"), "sp")
    return ("dp", "sp")


def _entry_index(mesh, entry, coords=None) -> Tuple[int, int]:
    """(index, count) along a spec entry (an axis name, a tuple of names
    flattened outermost first, or None): this rank's, or that of the rank
    at *coords* (axis name -> index)."""
    names = (() if entry is None else
             (entry,) if isinstance(entry, str) else tuple(entry))
    idx, count = 0, 1
    for name in names:
        n = col.axis_size(mesh, name)
        at = (col.axis_index(mesh, name) if coords is None
              else coords.get(name, 0))
        idx, count = idx * n + at, count * n
    return idx, count


# a tensor that already is this rank's block of a global batch carries
# this attribute (``data.prefetch_to_mesh``): ``local_batch`` keeps it
LOCAL_BLOCK = "_kubetpu_local_block"


def _region(shape, spec, mesh, coords=None) -> tuple:
    """The index of the block of a *shape* array that the rank at *coords*
    (this rank by default) holds under *spec*: each dimension cut into its
    axis's count of equal parts."""
    index = []
    for dim, entry in enumerate(spec):
        i, n = _entry_index(mesh, entry, coords)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {shape[dim]} does "
                             f"not split over {entry!r} ({n})")
        size = shape[dim] // n
        index.append(slice(i * size, (i + 1) * size))
    return tuple(index)


def _take(x, spec, mesh):
    """This rank's block of *x* (a numpy array or a tensor) under *spec*:
    each dimension cut into its axis's count of equal parts."""
    return x[_region(x.shape, spec, mesh)]


def whole_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape from a block's *shape* under *spec*."""
    return tuple(n * _entry_index(mesh, entry, {})[1]
                 for n, entry in zip(shape, spec))


def leaf_spec(specs: dict, name: str) -> tuple:
    """The spec of parameter *name* (a ``named_parameters`` name) in
    *specs*' tree, a block leaf's with its leading layer entry (the axes
    its gradient and its norm span)."""
    node = specs
    for part in name.split("."):
        if not part.isdigit():
            node = node[part]
    return tuple(node)


def local_spec(specs: dict, name: str) -> tuple:
    """The spec of parameter *name* as the module holds it: one layer of
    a block leaf, without the layer entry."""
    spec = leaf_spec(specs, name)
    return spec[1:] if any(p.isdigit() for p in name.split(".")) else spec


def global_name(name: str, first_layer: int) -> str:
    """The whole model's name of a shard's parameter *name*: a pipeline
    stage's local block ``i`` is global layer ``first_layer + i``."""
    parts = name.split(".")
    if not first_layer or "blocks" not in parts:
        return name
    i = parts.index("blocks") + 1
    parts[i] = str(int(parts[i]) + first_layer)
    return ".".join(parts)


def check_mesh(cfg: ModelConfig, mesh, pp: bool = False,
               vocab: bool = True) -> None:
    """Raise on what the sharded step does not take: axes other than
    dcn/dp/sp/tp/ep (and pp under *pp*), ep that does not divide the
    experts, and tp that does not divide heads, K/V heads, d_ff and (for
    a model with an LM head, *vocab*) the vocabulary."""
    allowed = {"dcn", "dp", "sp", "tp", "ep"} | ({"pp"} if pp else set())
    extra = set(mesh.mesh_dim_names) - allowed
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)} are not taken here "
                         f"(allowed: {sorted(allowed)})")
    ep = col.axis_size(mesh, "ep")
    if cfg.n_experts > 0 and cfg.n_experts % ep:
        raise ValueError(f"ep={ep} does not divide n_experts "
                         f"({cfg.n_experts})")
    tp = col.axis_size(mesh, "tp")
    for name, n in (("n_heads", cfg.n_heads), ("kv heads", cfg.kv_heads),
                    ("d_ff", cfg.d_ff)) + ((("vocab", cfg.vocab),)
                                           if vocab else ()):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {name} ({n})")
    if pp and cfg.n_layers % col.axis_size(mesh, "pp"):
        raise ValueError(f"pp={col.axis_size(mesh, 'pp')} does not divide "
                         f"n_layers ({cfg.n_layers})")


def stage_layers(cfg: ModelConfig, mesh) -> range:
    """The layers this rank's pipeline stage holds (all of them without
    a pp axis)."""
    n = cfg.n_layers // col.axis_size(mesh, "pp")
    first = col.axis_index(mesh, "pp") * n
    return range(first, first + n)


def local_model(cfg: ModelConfig, mesh, device,
                pp: bool = False) -> Transformer:
    """An uninitialized ``Transformer`` of this rank's shard shapes (its
    heads, ff and vocab shards, its experts, its stage's layers) on
    *device*."""
    return Transformer(cfg, device, tp=col.axis_size(mesh, "tp"),
                       layers=len(stage_layers(cfg, mesh)),
                       ep=col.axis_size(mesh, "ep"))


def shard_model(full: Transformer, cfg: ModelConfig, mesh,
                pp: bool = False) -> Transformer:
    """This rank's shard of *full* (``param_specs``), as a new
    ``Transformer`` of local shapes on *full*'s device carrying its
    ``ModelShard`` (so ``forward`` and the decode paths run it through its
    collectives); gradients off, as ``init_params`` leaves them. A model
    that already is a shard of *mesh* (``init_shard``, ``shard_params``,
    ``restore_checkpoint``'s target) comes back as it is. An int8 model is
    refused: its ``QTensor`` leaves have no sharding here, as the JAX
    package's ``param_specs`` have none for them."""
    check_mesh(cfg, mesh, pp)
    shard = getattr(full, "shard", None)
    if shard is not None:
        if shard.mesh is mesh and shard.pp == pp:
            return full
        raise ValueError("the model already is a shard of another mesh "
                         "or pipeline split")
    require_unquantized(full, "shard_model")
    specs = param_specs(cfg, pp)
    first = stage_layers(cfg, mesh).start
    wholes = dict(full.named_parameters())
    local = local_model(cfg, mesh, torch.device("meta"), pp)
    with torch.no_grad():
        for name, _p in list(local.named_parameters()):
            set_param(local, name, _take(wholes[global_name(name, first)],
                                         local_spec(specs, name), mesh)
                      .clone(memory_format=torch.contiguous_format))
    local.shard = col.model_shard(mesh, specs, moe=cfg.n_experts > 0, pp=pp)
    return local


def set_param(model: torch.nn.Module, name: str,
              value: torch.Tensor) -> None:
    """Replace parameter *name* of *model* (a meta-device placeholder) by
    *value*, gradients off."""
    *path, attr = name.split(".")
    module = model.get_submodule(".".join(path))
    delattr(module, attr)
    setattr(module, attr, torch.nn.Parameter(value.detach(),
                                             requires_grad=False))


def shard_routes(whole: torch.nn.Module, local: torch.nn.Module, specs,
                 mesh, first_layer: int = 0) -> dict:
    """``id(whole leaf) -> (the shard's leaf, its local spec)`` for every
    leaf the shard *local* holds, matched by name (a pipeline stage's
    blocks from *first_layer* on)."""
    wholes = dict(whole.named_parameters())
    return {id(wholes[global_name(name, first_layer)]):
            (p, local_spec(specs, name))
            for name, p in local.named_parameters()}


def draw_shard(plan, routes: dict, generator: torch.Generator,
               dtype: torch.dtype, device, mesh) -> None:
    """Fill a shard from the whole model's draw *plan* ((whole leaf,
    scale) in ``fill_plan``'s order, the whole leaves on any device, the
    meta device included) without ever holding the whole model: each leaf
    is drawn whole on *device* from *generator*, scaled in place, cut
    (``_take``) into its shard leaf (``routes``) and freed before the next
    is drawn, so a rank holds its shard plus one whole leaf and the shards
    equal those of ``fill_plan`` with the same generator bit for bit (both
    draw by ``model.normal_draw``). A leaf the shard does not hold
    (another stage's layer) is drawn all the same: the draws that follow
    it must not move."""
    draw = model_lib.normal_draw(generator, dtype, device)
    with torch.no_grad():
        for p, scale in plan:
            route = routes.get(id(p))
            if scale is None:
                if route is not None:
                    route[0].fill_(1.0)
                continue
            x = draw(p.shape, scale)
            if route is not None:
                route[0].copy_(_take(x, route[1], mesh))
            del x


def init_shard(generator: torch.Generator, cfg: ModelConfig, mesh,
               device=None, pp: bool = False) -> Transformer:
    """This rank's shard of ``init_params(generator, cfg)`` (*pp*: its
    pipeline stage's layers), carrying its ``ModelShard``, gradients off,
    drawn leaf by leaf (``draw_shard``): equal bit for bit to
    ``shard_model(init_params(generator, cfg), cfg, mesh, pp)``, at a peak
    of the shard plus the largest leaf."""
    device = resolve_device(device)
    check_mesh(cfg, mesh, pp)
    local = local_model(cfg, mesh, device, pp)
    whole = Transformer(cfg, torch.device("meta"))
    specs = param_specs(cfg, pp)
    draw_shard(model_lib.model_plan(whole),
               shard_routes(whole, local, specs, mesh,
                            stage_layers(cfg, mesh).start),
               generator, cfg.dtype, device, mesh)
    local.shard = col.model_shard(mesh, specs, moe=cfg.n_experts > 0, pp=pp)
    return local


class GradSync:
    """The cross-rank half of a sharded update. Each leaf's gradient is
    summed over the axes whose ranks each hold a part of it (the data axes
    and sp always: every rank's loss is the global mean, so its gradient
    is its own tokens' share; pp too for a leaf only one stage computes),
    in f32 buckets; a leaf replicated over tp or ep is never summed over
    them (every such rank computed all of it: tokens are replicated over
    ep, and the router's gradient through the experts' combine is summed
    inside the block). The squared global norm sums each leaf's squares
    over the axes it is sharded on (an expert leaf's over ep) and counts a
    replicated leaf once; the finite check holds on every rank or on
    none."""

    BUCKET = 1 << 26      # f32 elements a reduction carries (256 MiB)

    def __init__(self, groups: col.MeshGroups,
                 reduce_axes: Sequence[Tuple[str, ...]],
                 shard_axes: Sequence[Tuple[str, ...]]) -> None:
        self.groups = groups
        self.reduce_axes = list(reduce_axes)
        self.shard_axes = list(shard_axes)

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = list(grads)
        by_axes: dict = {}
        for i, axes in enumerate(self.reduce_axes):
            by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            group = self.groups.over(*axes)
            if group is None:
                continue
            label = "dp" if set(axes) & {"dcn", "dp"} else axes[0]
            bucket: List[int] = []
            for pos, i in enumerate(idx):
                bucket.append(i)
                size = sum(out[j].numel() for j in bucket)
                if size >= self.BUCKET or pos == len(idx) - 1:
                    flat = torch.cat([out[j].float().reshape(-1)
                                      for j in bucket])
                    col.all_reduce_(flat, group, label)
                    for j, part in zip(bucket, flat.split(
                            [out[j].numel() for j in bucket])):
                        out[j] = part.view_as(out[j]).to(out[j].dtype)
                    bucket = []
        return out

    @torch.no_grad()
    def sq_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        total = None
        by_axes: dict = {}
        for g, axes in zip(grads, self.shard_axes):
            sq = (g.float() * g.float()).sum()
            by_axes[axes] = by_axes.get(axes, 0.0) + sq
        for axes, sq in by_axes.items():
            sq = col.all_reduce_(sq.reshape(1).clone(),
                                 self.groups.over(*axes), "norm")[0]
            total = sq if total is None else total + sq
        return total

    @torch.no_grad()
    def all_ok(self, ok: torch.Tensor) -> torch.Tensor:
        flag = ok.to(torch.float32).reshape(1)
        col.all_reduce_(flag, self.groups.over(
            *self.groups.mesh.mesh_dim_names), "ok",
            op=torch.distributed.ReduceOp.MIN)
        return flag[0] > 0


DATA_SP = ("dcn", "dp", "sp")


def sync_for(leaf_specs, groups: col.MeshGroups,
             data_axes: Sequence[str] = DATA_SP,
             pp: bool = False) -> GradSync:
    """The ``GradSync`` of a shard whose leaves, in ``parameters()``
    order, are *leaf_specs* ((name, ``leaf_spec``) pairs): every gradient
    summed over the mesh's *data_axes* (the axes whose ranks hold other
    tokens; under *pp* the embedding's over pp too: only the first stage
    embeds), each leaf's squares over the axes it is sharded on."""
    names = groups.mesh.mesh_dim_names
    data = tuple(a for a in data_axes if a in names)
    reduce_axes, shard_axes = [], []
    for name, spec in leaf_specs:
        extra = ("pp",) if pp and name.split(".")[-1] == "embed" else ()
        reduce_axes.append(data + extra)
        shard_axes.append(tuple(a for a in spec if a in names))
    return GradSync(groups, reduce_axes, shard_axes)


def grad_sync(cfg: ModelConfig, groups: col.MeshGroups, pp: bool = False,
              data_axes: Sequence[str] = DATA_SP) -> GradSync:
    """The ``GradSync`` of a rank's shard (``shard_model``), its leaves in
    the order of ``Transformer.parameters()``, read off a meta-device
    model of the shard's shapes. *data_axes*: the axes whose ranks hold
    other tokens (the encoder's replicated sequence leaves sp out)."""
    specs = param_specs(cfg, pp)
    shard = local_model(cfg, groups.mesh, torch.device("meta"), pp)
    return sync_for([(name, leaf_spec(specs, name))
                     for name, _ in shard.named_parameters()], groups,
                    data_axes, pp)


def _positions(sp_index: int, s_local: int, device) -> torch.Tensor:
    """The RoPE positions of sp rank *sp_index*'s block: its global
    positions ``sp_index * s_local ...``."""
    return torch.arange(sp_index * s_local, (sp_index + 1) * s_local,
                        dtype=torch.int32, device=device)


def _vocab_parallel_sums(x, head, targets, weights, cfg: ModelConfig,
                         tp_group, vocab_start: int):
    """(sum of weighted per-position losses, sum of weights) of this
    rank's positions, with the head's vocab split over tp: the
    log-sum-exp, the target's logit and (for label smoothing) the mean
    logit are sums over the vocab shards (``reduce_from``), so the value
    is ``lm_loss_tail``'s per-position loss, label smoothing and z-loss
    included."""
    logits = torch.einsum("bsd,dv->bsv", col.copy_to(x, tp_group),
                          head).float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    col.all_reduce_(m, tp_group, "tp", torch.distributed.ReduceOp.MAX)
    lse = m[..., 0] + torch.log(col.reduce_from(
        torch.exp(logits - m).sum(dim=-1), tp_group))
    local = targets.long() - vocab_start
    mine = (local >= 0) & (local < head.shape[1])
    tgt = torch.gather(logits, -1, local.clamp(0, head.shape[1] - 1)[
        ..., None])[..., 0]
    tgt = col.reduce_from(torch.where(mine, tgt, 0.0), tp_group)
    nll = lse - tgt
    if cfg.label_smoothing > 0:
        mean_logit = col.reduce_from(logits.sum(dim=-1), tp_group) / cfg.vocab
        nll = ((1.0 - cfg.label_smoothing) * nll
               - cfg.label_smoothing * (mean_logit - lse))
    if cfg.z_loss > 0:
        nll = nll + cfg.z_loss * lse.square()
    return (nll * weights).sum(), weights.sum()


def sharded_loss_tail(x, head, targets, weights, cfg: ModelConfig,
                      groups: col.MeshGroups,
                      data_axes: Sequence[str] = DATA_SP):
    """The global mean loss from this rank's final-norm hidden states
    (B_local, S_local, D): the vocab-parallel per-position losses
    (streamed over ``cfg.loss_chunk`` positions at a time when set, each
    chunk recomputed in the backward), numerator and denominator summed
    over *data_axes* (the data axes and sp; the encoder's replicated
    sequence leaves sp out). Identical on every rank."""
    tp_group = groups.over("tp")
    vocab_start = col.axis_index(groups.mesh, "tp") * head.shape[1]
    if weights is None:
        weights = torch.ones(targets.shape, dtype=torch.float32,
                             device=x.device)
    weights = weights.float()
    s_local = x.shape[1]
    chunk = cfg.loss_chunk or s_local
    if s_local % chunk:
        raise ValueError(f"loss_chunk ({chunk}) must divide the rank's "
                         f"sequence block ({s_local})")
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s_local, chunk):
        args = (x[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk],
                weights[:, c0:c0 + chunk], cfg, tp_group, vocab_start)
        if cfg.loss_chunk and torch.is_grad_enabled():
            n, w = checkpoint(_vocab_parallel_sums, *args,
                              use_reentrant=False)
        else:
            n, w = _vocab_parallel_sums(*args)
        num, den = num + n, den + w
    data_sp = groups.over(*data_axes)
    num = col.reduce_from(num, data_sp, "dp")
    den = col.reduce_from(den.detach(), data_sp, "dp")
    return num / torch.clamp(den, min=1.0)


def local_batch(x, mesh):
    """This rank's block of a global (B, S) batch array: rows on the data
    axes, columns on sp (``batch_spec``). A block ``prefetch_to_mesh``
    already cut (``LOCAL_BLOCK``) comes back as it is."""
    if getattr(x, LOCAL_BLOCK, False):
        return x
    return _take(x, batch_spec(mesh), mesh)


def step_shard(cfg: ModelConfig, groups: col.MeshGroups,
               data_axes=("dcn", "dp", "sp")) -> col.ModelShard:
    """The ``ModelShard`` a sharded step's blocks run under: a MoE
    capacity dispatch and the load-balance term span *data_axes* (the
    global batch, as GSPMD computes them)."""
    return col.model_shard(groups.mesh, moe=cfg.n_experts > 0,
                           data_axes=data_axes)


def _mesh_loss_fn(cfg: ModelConfig, attn_fn, groups: col.MeshGroups):
    mesh = groups.mesh
    body = partial(model_lib._block_output, shard=step_shard(cfg, groups))
    sp_index = col.axis_index(mesh, "sp")

    def loss_fn(params, tokens, targets, weights=None):
        tokens, targets = local_batch(tokens, mesh), local_batch(targets,
                                                                 mesh)
        if weights is not None:
            weights = local_batch(weights, mesh)
        positions = _positions(sp_index, tokens.shape[1], tokens.device)
        x, aux = model_lib.run_blocks(cfg, attn_fn, positions,
                                      params.embed[tokens], params.blocks,
                                      body=body)
        x = rms_norm(x, params.ln_f)
        loss = sharded_loss_tail(x, params.head, targets, weights, cfg,
                                 groups)
        if cfg.n_experts > 0 and cfg.moe_aux_coeff > 0:
            # the term is global (its means span the data axes) and alike
            # on every rank: counted once, as the one-card loss counts it
            loss = loss + cfg.moe_aux_coeff * aux
        return loss

    return loss_fn


def _resolve_attention(attention: str, window: int = 0, mesh=None):
    """The attention core: 'ring' / 'ring_flash' (sequence-parallel over
    the mesh's sp ring: the dense ring, or the flash kernels in every ring
    step; with ``window`` both take the banded ring; without a mesh, a
    ring of one), 'flash' (the CUDA
    flash kernels through ``flash_attention``; their plain versions for CPU
    tensors) or 'dense' (``dense_attention``), all banded by ``window``.
    'flash' and 'dense' see only the rank's own block, so a mesh with
    sp > 1 takes a ring."""
    if attention in ("ring", "ring_flash"):
        impl = "flash" if attention == "ring_flash" else "dense"
        return make_ring_attention(mesh, impl=impl, window=window)
    if attention in ("flash", "dense") and col.axis_size(mesh, "sp") > 1:
        raise ValueError(f"attention={attention!r} sees only this rank's "
                         "sequence block; an sp > 1 mesh takes 'ring' or "
                         "'ring_flash'")
    if attention == "flash":
        from kubetpu_torch.ops.flash_attention import flash_attention

        return partial(flash_attention, causal=True, window=window)
    if attention == "dense":
        return partial(model_lib.dense_attention, causal=True, window=window)
    raise ValueError(f"unknown attention {attention!r}")


def _uploader(device: torch.device):
    def up(x, dtype=None):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        out = t.to(device=device, dtype=dtype, non_blocking=True)
        if out is not t and getattr(t, LOCAL_BLOCK, False):
            setattr(out, LOCAL_BLOCK, True)
        return out

    return up


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    attention: str = "flash", accum_steps: int = 1,
                    skip_nonfinite: bool = False, weighted: bool = False,
                    device=None, mesh=None):
    """The full training step: loss -> gradients -> AdamW.

    Pass the optimizer returned by ``init_state``. ``attention``: 'flash'
    (default) or 'dense'; on a mesh also 'ring' or 'ring_flash'.
    ``weighted=True`` makes the step ``(state, tokens, targets, weights)``
    with per-position loss weights (the packed-batch path). Batches may be
    numpy arrays (uploaded to *device*, the card by default) or tensors
    already there.

    With *mesh* (``meshjob.make_mesh``: axes dp, sp, tp, and dcn for
    multislice) every rank of the mesh calls the step with the same GLOBAL
    batch and ``init_state(..., mesh=mesh)``'s state; each computes its
    block (``local_batch``) on its shard of the model and returns the
    global mean loss. Gradients are summed over dp x sp (x dcn) and never
    over tp; ``accum_steps`` splits the global batch as on one card."""
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = _resolve_attention(attention, cfg.window, mesh)
    if mesh is None:
        def loss_fn(params, tokens, targets, weights=None):
            return model_lib.next_token_loss(params, tokens, targets, cfg,
                                             attn_fn, weights=weights)
        sync = None
    else:
        check_mesh(cfg, mesh)
        groups = col.groups_of(mesh)
        loss_fn = _mesh_loss_fn(cfg, attn_fn, groups)
        sync = grad_sync(cfg, groups)

    step = make_update_step(loss_fn, optimizer, accum_steps=accum_steps,
                            skip_nonfinite=skip_nonfinite, sync=sync)

    def train_step(state: TrainState, tokens, targets, *weights):
        if len(weights) != int(weighted):
            raise TypeError(f"weighted={weighted}: the step takes "
                            f"{2 + int(weighted)} batch arrays")
        batch = (up(tokens, torch.int64), up(targets, torch.int64),
                 *(up(w, torch.float32) for w in weights))
        return step(state, *batch)

    return train_step


def make_eval_step(cfg: ModelConfig, attention: str = "flash", device=None,
                   mesh=None):
    """``eval_step(params, tokens, targets) -> loss`` without gradients,
    through the same attention core as training, so that it measures the
    training objective (a windowed config evaluates banded). On a *mesh*
    every rank passes the global batch and gets the global mean."""
    up = _uploader(resolve_device(device))
    attn_fn = _resolve_attention(attention, cfg.window, mesh)
    if mesh is not None:
        check_mesh(cfg, mesh)
        mesh_loss = _mesh_loss_fn(cfg, attn_fn, col.groups_of(mesh))

    @torch.no_grad()
    def eval_step(params, tokens, targets):
        require_unquantized(params, "make_eval_step")
        tokens, targets = up(tokens, torch.int64), up(targets, torch.int64)
        if mesh is not None:
            return mesh_loss(params, tokens, targets)
        return model_lib.next_token_loss(params, tokens, targets, cfg,
                                         attn_fn)

    return eval_step
