"""Vision Transformer (port of ``kubetpu/jobs/vision.py``).

Patchify -> linear projection -> learned position embeddings -> the
decoder's transformer blocks (``model.Block``) under a bidirectional core
-> mean-pool -> classification head. Patchify is a reshape and one matmul
(no convolution). Rotary embeddings are neutralized by feeding position 0
everywhere (rope at angle 0 is the identity), so the shared block body
needs no flag: image order comes from the learned position table, as in
ViT.

Not ported yet: ``vit_param_specs`` and the sharded step (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs.encoder import (bidirectional_attention,
                                        dense_bidirectional_attention)
from kubetpu_torch.jobs.model import ModelConfig, _param, resolve_device
from kubetpu_torch.jobs.train import (AdamW, TrainState, _uploader,
                                      make_optimizer, make_update_step,
                                      refuse_mesh, state_from_params)


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
    ``init_vit_params`` or ``convert.vit_params_from_numpy`` fill them."""

    def __init__(self, cfg: VitConfig, device) -> None:
        super().__init__()
        mcfg = cfg.model
        self.cfg = cfg
        self.patch_proj = _param((cfg.patch_dim, mcfg.d_model), mcfg, device)
        self.pos_embed = _param((cfg.n_patches, mcfg.d_model), mcfg, device)
        self.blocks = nn.ModuleList(
            [model_lib.Block(mcfg, device) for _ in range(mcfg.n_layers)])
        self.ln_f = _param((mcfg.d_model,), mcfg, device)
        self.head_cls = _param((mcfg.d_model, cfg.n_classes), mcfg, device)


def init_vit_params(generator: torch.Generator, cfg: VitConfig,
                    device=None) -> VisionTransformer:
    """Random weights with ``kubetpu.jobs.vision.init_vit_params``'s shapes
    and scales: the blocks by ``model.init_params``'s rule, the patch
    projection ``* patch_dim**-0.5``, the position table ``* 0.02``, the
    head ``* d**-0.5``; drawn from *generator*, which must live on
    *device* (the card by default)."""
    device = resolve_device(device)
    mcfg = cfg.model
    normal_ = model_lib.normal_filler(generator, mcfg.dtype, device)
    model = VisionTransformer(cfg, device)
    with torch.no_grad():
        model_lib.init_blocks_(model.blocks, mcfg, normal_)
        model.ln_f.fill_(1.0)
        normal_(model.patch_proj, cfg.patch_dim ** -0.5)
        normal_(model.pos_embed, 0.02)
        normal_(model.head_cls, mcfg.d_model ** -0.5)
    return model


def patchify(images: torch.Tensor, cfg: VitConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C) by reshape and permute only: patch n
    is row-major over the grid, its pixels row-major inside it."""
    b = images.shape[0]
    p, side = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, side, p, side, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)            # (B, side, side, p, p, C)
    return x.reshape(b, cfg.n_patches, cfg.patch_dim)


def vit_forward(params: VisionTransformer, images: torch.Tensor,
                cfg: VitConfig, attn_fn=None, return_aux: bool = False):
    """Class logits, differentiable: images (B, H, W, C) float ->
    (B, n_classes) f32; with ``return_aux`` also the summed MoE
    load-balance term. Each block is recomputed in the backward under
    ``cfg.model.remat``."""
    mcfg = cfg.model
    attn = attn_fn or dense_bidirectional_attention
    x = patchify(images.to(mcfg.dtype), cfg) @ params.patch_proj
    x = x + params.pos_embed[None]
    # position 0 everywhere -> rope is the identity inside the shared block
    positions = torch.zeros((cfg.n_patches,), dtype=torch.int32,
                            device=x.device)
    x, aux = model_lib.run_blocks(mcfg, attn, positions, x, params.blocks)
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
    *device* (the card by default) and a zero AdamW state."""
    refuse_mesh(mesh, "init_vit_state")
    optimizer = optimizer or make_optimizer()
    params = init_vit_params(generator, cfg, resolve_device(device))
    return state_from_params(params, optimizer), optimizer


def make_vit_train_step(cfg: VitConfig, optimizer: Optional[AdamW] = None,
                        attention: str = "dense", mesh=None, device=None):
    """``step(state, images, labels) -> (state, loss)``: the classification
    loss -> gradients -> AdamW, in place, on *device* (the card by
    default). ``attention``: 'dense' or 'flash' (the flash kernels with
    ``causal=False``). Batches may be numpy arrays (uploaded) or tensors
    already on the device."""
    refuse_mesh(mesh, "make_vit_train_step")
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = bidirectional_attention(attention, "vit")

    def loss_fn(params, images, labels):
        return vit_loss(params, images, labels, cfg, attn_fn=attn_fn)

    step = make_update_step(loss_fn, optimizer)

    def train_step(state: TrainState, images, labels):
        return step(state, up(images, torch.float32),
                    up(labels, torch.int64))

    return train_step
