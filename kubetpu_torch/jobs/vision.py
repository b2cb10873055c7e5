"""Vision Transformer (port of ``kubetpu/jobs/vision.py``).

Patchify -> linear projection -> learned position embeddings -> the
decoder's transformer blocks (``model.Block``) under a bidirectional core
-> mean-pool -> classification head. Patchify is a reshape and one matmul
(no convolution). Rotary embeddings are neutralized by feeding position 0
everywhere (rope at angle 0 is the identity), so the shared block body
needs no flag: image order comes from the learned position table, as in
ViT.

Over a mesh (``init_vit_state(..., mesh=)``, ``make_vit_train_step(...,
mesh=)``) the images and labels go on dp, the blocks take training's tp
(and ep) specs (``vit_param_specs``) and run tensor-parallel, and
``patch_proj``, ``pos_embed``, ``ln_f`` and ``head_cls`` are replicated:
every tp rank computes their whole gradient, which is summed over dp and
never over tp.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch
from torch import nn

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs import train as train_lib
from kubetpu_torch.jobs.encoder import (ENCODER_DATA,
                                        bidirectional_attention,
                                        dense_bidirectional_attention)
from kubetpu_torch.jobs.model import ModelConfig, _param, resolve_device
from kubetpu_torch.jobs.train import (AdamW, TrainState, _uploader,
                                      make_optimizer, make_update_step,
                                      state_from_params)


@dataclasses.dataclass(frozen=True)
class VitConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    n_classes: int = 10
    model: ModelConfig = dataclasses.field(
        default_factory=lambda: ModelConfig(d_model=128, n_layers=4,
                                            n_heads=4, d_ff=256))

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"patch_size ({self.patch_size}) must divide "
                f"image_size ({self.image_size})")

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


class VisionTransformer(nn.Module):
    """``patch_proj (P*P*C, d)``, ``pos_embed (N, d)``, one ``model.Block``
    per layer, ``ln_f (d,)`` and ``head_cls (d, n_classes)``, in the JAX
    package's layouts. Constructed with uninitialized weights;
    ``init_vit_params`` or ``convert.vit_params_from_numpy`` fill them.
    With ``tp``/``ep`` > 1 the blocks are one rank's shard (``Block``), and
    ``shard`` is the ``collectives.ModelShard`` it runs under."""

    shard: Optional[col.ModelShard] = None

    def __init__(self, cfg: VitConfig, device, tp: int = 1,
                 ep: int = 1) -> None:
        super().__init__()
        mcfg = cfg.model
        self.cfg = cfg
        self.patch_proj = _param((cfg.patch_dim, mcfg.d_model), mcfg, device)
        self.pos_embed = _param((cfg.n_patches, mcfg.d_model), mcfg, device)
        self.blocks = nn.ModuleList(
            [model_lib.Block(mcfg, device, tp, ep)
             for _ in range(mcfg.n_layers)])
        self.ln_f = _param((mcfg.d_model,), mcfg, device)
        self.head_cls = _param((mcfg.d_model, cfg.n_classes), mcfg, device)


def vit_plan(model: VisionTransformer):
    """Every leaf of a whole ViT with its scale, in ``init_vit_params``'
    draw order (``model.fill_plan``)."""
    cfg, mcfg = model.cfg, model.cfg.model
    yield from model_lib.blocks_plan(model.blocks, mcfg)
    yield from ((model.ln_f, None),
                (model.patch_proj, cfg.patch_dim ** -0.5),
                (model.pos_embed, 0.02),
                (model.head_cls, mcfg.d_model ** -0.5))


def init_vit_params(generator: torch.Generator, cfg: VitConfig,
                    device=None) -> VisionTransformer:
    """Random weights with ``kubetpu.jobs.vision.init_vit_params``'s shapes
    and scales: the blocks by ``model.init_params``'s rule, the patch
    projection ``* patch_dim**-0.5``, the position table ``* 0.02``, the
    head ``* d**-0.5``; drawn from *generator*, which must live on
    *device* (the card by default)."""
    device = resolve_device(device)
    model = VisionTransformer(cfg, device)
    model_lib.fill_plan(vit_plan(model), model_lib.normal_filler(
        generator, cfg.model.dtype, device))
    return model


def vit_param_specs(cfg: VitConfig) -> dict:
    """The axis each dimension of each leaf shards on: the blocks take
    training's (``train.param_specs``: heads and ff on tp, experts on
    ep), the ViT's own leaves are replicated."""
    return {"patch_proj": (None, None), "pos_embed": (None, None),
            "blocks": train_lib.param_specs(cfg.model)["blocks"],
            "ln_f": (None,), "head_cls": (None, None)}


def init_vit_shard(generator: torch.Generator, cfg: VitConfig, mesh,
                   device=None) -> VisionTransformer:
    """This rank's shard of ``init_vit_params(generator, cfg)``, drawn
    leaf by leaf (``train.draw_shard``: the shard plus one whole leaf at
    a time, equal bit for bit to cutting the whole model)."""
    device = resolve_device(device)
    mcfg = cfg.model
    train_lib.check_mesh(mcfg, mesh, vocab=False)
    local = VisionTransformer(cfg, device, tp=col.axis_size(mesh, "tp"),
                              ep=col.axis_size(mesh, "ep"))
    whole = VisionTransformer(cfg, torch.device("meta"))
    specs = vit_param_specs(cfg)
    train_lib.draw_shard(vit_plan(whole), train_lib.shard_routes(
        whole, local, specs, mesh), generator, mcfg.dtype, device, mesh)
    local.shard = col.model_shard(mesh, specs, moe=mcfg.n_experts > 0)
    return local


def patchify(images: torch.Tensor, cfg: VitConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C) by reshape and permute only: patch n
    is row-major over the grid, its pixels row-major inside it."""
    b = images.shape[0]
    p, side = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, side, p, side, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)            # (B, side, side, p, p, C)
    return x.reshape(b, cfg.n_patches, cfg.patch_dim)


def vit_forward(params: VisionTransformer, images: torch.Tensor,
                cfg: VitConfig, attn_fn=None, return_aux: bool = False,
                shard=None):
    """Class logits, differentiable: images (B, H, W, C) float ->
    (B, n_classes) f32; with ``return_aux`` also the summed MoE
    load-balance term. Each block is recomputed in the backward under
    ``cfg.model.remat``. A shard's blocks run under *shard* (its
    ``ModelShard`` by default)."""
    mcfg = cfg.model
    attn = attn_fn or dense_bidirectional_attention
    if shard is None:
        shard = params.shard
    x = patchify(images.to(mcfg.dtype), cfg) @ params.patch_proj
    x = x + params.pos_embed[None]
    # position 0 everywhere -> rope is the identity inside the shared block
    positions = torch.zeros((cfg.n_patches,), dtype=torch.int32,
                            device=x.device)
    x, aux = model_lib.run_blocks(mcfg, attn, positions, x, params.blocks,
                                  body=partial(model_lib._block_output,
                                               shard=shard))
    x = model_lib.rms_norm(x.mean(dim=1), params.ln_f)      # mean-pool
    logits = torch.einsum("bd,dc->bc", x, params.head_cls).float()
    return (logits, aux) if return_aux else logits


def vit_loss(params: VisionTransformer, images, labels, cfg: VitConfig,
             attn_fn=None) -> torch.Tensor:
    """Classification cross-entropy; MoE configs add ``moe_aux_coeff``
    times the load-balance term, as every other family does."""
    mcfg = cfg.model
    logits, aux = vit_forward(params, images, cfg, attn_fn=attn_fn,
                              return_aux=True)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, labels[:, None].long()).mean()
    if mcfg.n_experts > 0 and mcfg.moe_aux_coeff > 0:
        loss = loss + mcfg.moe_aux_coeff * aux
    return loss


def init_vit_state(generator: torch.Generator, cfg: VitConfig,
                   optimizer: Optional[AdamW] = None, mesh=None,
                   device=None):
    """-> (TrainState, optimizer): random weights from *generator* on
    *device* (the card by default) and a zero AdamW state; with *mesh*,
    this rank's shard of them (``init_vit_shard``)."""
    optimizer = optimizer or make_optimizer()
    if mesh is not None:
        params = init_vit_shard(generator, cfg, mesh, device)
    else:
        params = init_vit_params(generator, cfg, resolve_device(device))
    return state_from_params(params, optimizer), optimizer


def vit_mesh_parts(cfg: VitConfig, attn_fn, mesh):
    """(loss_fn, sync) of the sharded ViT step on *mesh*: this rank's
    images and labels (rows on the data axes), the blocks through its
    shard, the mean cross-entropy over the global batch; every gradient
    summed over the data axes only."""
    mcfg = cfg.model
    groups = col.groups_of(mesh)
    shard = train_lib.step_shard(mcfg, groups, data_axes=ENCODER_DATA)
    rows = train_lib.batch_spec(mesh)[0]
    data = groups.over(*ENCODER_DATA)

    def loss_fn(params, images, labels):
        images = train_lib._take(images, (rows, None, None, None), mesh)
        labels = train_lib._take(labels, (rows,), mesh)
        logits, aux = vit_forward(params, images, cfg, attn_fn=attn_fn,
                                  return_aux=True, shard=shard)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None].long()).sum()
        loss = col.reduce_from(nll, data, "dp") / (
            labels.shape[0] * col.group_size(data))
        if mcfg.n_experts > 0 and mcfg.moe_aux_coeff > 0:
            loss = loss + mcfg.moe_aux_coeff * aux
        return loss

    specs = vit_param_specs(cfg)
    local = VisionTransformer(cfg, torch.device("meta"),
                              tp=col.axis_size(mesh, "tp"),
                              ep=col.axis_size(mesh, "ep"))
    sync = train_lib.sync_for(
        [(n, train_lib.leaf_spec(specs, n))
         for n, _ in local.named_parameters()], groups, ENCODER_DATA)
    return loss_fn, sync


def make_vit_train_step(cfg: VitConfig, optimizer: Optional[AdamW] = None,
                        attention: str = "dense", mesh=None, device=None):
    """``step(state, images, labels) -> (state, loss)``: the classification
    loss -> gradients -> AdamW, in place, on *device* (the card by
    default). ``attention``: 'dense' or 'flash' (the flash kernels with
    ``causal=False``). Batches may be numpy arrays (uploaded) or tensors
    already on the device. With *mesh* every rank passes the GLOBAL batch
    and ``init_vit_state(..., mesh=)``'s state (``vit_mesh_parts``)."""
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = bidirectional_attention(attention, "vit")
    sync = None
    if mesh is None:
        def loss_fn(params, images, labels):
            return vit_loss(params, images, labels, cfg, attn_fn=attn_fn)
    else:
        train_lib.check_mesh(cfg.model, mesh, vocab=False)
        loss_fn, sync = vit_mesh_parts(cfg, attn_fn, mesh)

    step = make_update_step(loss_fn, optimizer, sync=sync)

    def train_step(state: TrainState, images, labels):
        return step(state, up(images, torch.float32),
                    up(labels, torch.int64))

    return train_step
