"""Bidirectional encoder, BERT-style masked LM (port of
``kubetpu/jobs/encoder.py``).

An encoder is ``model.forward`` with a full-visibility attention core
instead of the causal one: the decoder's blocks, init and loss tail are
reused as they are. The new code is the masked-token objective and the
train step. On the card the bidirectional core is the flash kernels with
``causal=False`` (``kubetpu_torch.ops.flash_attention``: forward, dQ and
dK/dV), the same kernels as the decoder's causal training step.

Over a mesh (``make_mlm_train_step(..., mesh=)``, the state from
``train.init_state(..., mesh=)``) the batch goes on dp only and the
sequence is replicated over sp, as the JAX step shards it: there is no
causal ring for an encoder, so each rank runs the bidirectional core over
the whole sequence at its ``H/tp`` heads. The loss tail is vocab-parallel
(``train.sharded_loss_tail``, weighted by the masked positions) and its
sums, like the gradients, run over dp only: the sp ranks hold the same
tokens, so a sum over sp would count each of them sp times.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs import train as train_lib
from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device
from kubetpu_torch.jobs.train import (AdamW, _uploader, make_optimizer,
                                      make_update_step)

# the axes whose ranks hold other rows of an encoder's batch: the sequence
# is replicated over sp
ENCODER_DATA = ("dcn", "dp")


def dense_bidirectional_attention(q, k, v):
    """Full-visibility softmax attention, (B, S, H, D) in and out
    (``model.dense_attention`` with the causal mask off): the plain core of
    the encoder, ViT and the seq2seq cross branch."""
    return model_lib.dense_attention(q, k, v, causal=False)


def bidirectional_attention(attention: str, what: str):
    """The full-visibility core for a train step: 'flash' (the flash
    kernels with ``causal=False``) or 'dense'."""
    if attention == "flash":
        from kubetpu_torch.ops.flash_attention import flash_attention

        return partial(flash_attention, causal=False)
    if attention == "dense":
        return dense_bidirectional_attention
    raise ValueError(f"unknown {what} attention {attention!r}")


def encoder_forward(params: Transformer, tokens: torch.Tensor,
                    cfg: ModelConfig, attn_fn=None,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits with every position attending to all positions: tokens
    (B, S) -> (B, S, V), without gradients (``model.forward``)."""
    return model_lib.forward(params, tokens, cfg,
                             attn_fn=attn_fn or dense_bidirectional_attention,
                             positions=positions)


def masked_lm_loss(params: Transformer, tokens: torch.Tensor,
                   mask_positions: torch.Tensor, mask_id: int,
                   cfg: ModelConfig, attn_fn=None) -> torch.Tensor:
    """BERT objective, differentiable: the positions flagged in
    *mask_positions* (bool (B, S)) are replaced by *mask_id* and the
    original tokens predicted there; only masked positions enter the mean.
    MoE configs add ``moe_aux_coeff`` times the load-balance term, as
    ``next_token_loss`` does."""
    corrupted = torch.where(mask_positions, mask_id, tokens)
    attn = attn_fn or dense_bidirectional_attention
    x, aux = model_lib.forward_hidden(params, corrupted, cfg, attn_fn=attn)
    loss = model_lib.lm_loss_tail(x, params.head, tokens, cfg,
                                  weights=mask_positions)
    if cfg.n_experts > 0 and cfg.moe_aux_coeff > 0:
        loss = loss + cfg.moe_aux_coeff * aux
    return loss


def rows_spec(mesh) -> tuple:
    """A (B, S) batch with its rows on the data axes and the sequence
    replicated (``train.batch_spec`` without sp)."""
    return (train_lib.batch_spec(mesh)[0], None)


def mlm_mesh_parts(cfg: ModelConfig, mask_id: int, attn_fn, mesh):
    """(loss_fn, sync) of the sharded masked-LM step on *mesh*: the loss
    of this rank's rows through its shard (``ENCODER_DATA`` for the loss
    tail's sums, a MoE capacity dispatch and the gradients), and the
    ``GradSync`` that sums the gradients over those axes only."""
    groups = col.groups_of(mesh)
    body = partial(model_lib._block_output, shard=train_lib.step_shard(
        cfg, groups, data_axes=ENCODER_DATA))
    spec = rows_spec(mesh)

    def loss_fn(params, tokens, mask_positions):
        tokens = train_lib._take(tokens, spec, mesh)
        mask_positions = train_lib._take(mask_positions, spec, mesh)
        corrupted = torch.where(mask_positions, mask_id, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x, aux = model_lib.run_blocks(cfg, attn_fn, positions,
                                      params.embed[corrupted], params.blocks,
                                      body=body)
        x = model_lib.rms_norm(x, params.ln_f)
        loss = train_lib.sharded_loss_tail(
            x, params.head, tokens, mask_positions, cfg, groups,
            data_axes=ENCODER_DATA)
        if cfg.n_experts > 0 and cfg.moe_aux_coeff > 0:
            loss = loss + cfg.moe_aux_coeff * aux
        return loss

    return loss_fn, train_lib.grad_sync(cfg, groups,
                                        data_axes=ENCODER_DATA)


def make_mlm_train_step(cfg: ModelConfig, mask_id: int,
                        optimizer: Optional[AdamW] = None,
                        attention: str = "dense", mesh=None, device=None):
    """``step(state, tokens, mask_positions) -> (state, loss)``: the
    masked-LM loss -> gradients -> AdamW, in place, on *device* (the card
    by default). ``attention``: 'dense' or 'flash' (the flash kernels with
    ``causal=False``). Batches may be numpy arrays (uploaded) or tensors
    already on the device. With *mesh* every rank passes the GLOBAL batch
    and ``train.init_state(..., mesh=)``'s state, and gets the global
    loss (``mlm_mesh_parts``)."""
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    attn_fn = bidirectional_attention(attention, "encoder")
    sync = None
    if mesh is None:
        def loss_fn(params, tokens, mask_positions):
            return masked_lm_loss(params, tokens, mask_positions, mask_id,
                                  cfg, attn_fn=attn_fn)
    else:
        train_lib.check_mesh(cfg, mesh)
        loss_fn, sync = mlm_mesh_parts(cfg, mask_id, attn_fn, mesh)

    step = make_update_step(loss_fn, optimizer, sync=sync)

    def train_step(state, tokens, mask_positions):
        return step(state, up(tokens, torch.int64),
                    up(mask_positions, torch.bool))

    return train_step
