"""Encoder-decoder, seq2seq (port of ``kubetpu/jobs/seq2seq.py``).

The decoder's blocks do the heavy lifting in both stacks
(``model._block_with_aux`` is the self-attention + MLP body of each), and
the new math is the cross-attention branch through which every decoder
position reads the encoder's memory:

- the encoder is ``model.forward_hidden`` under the bidirectional core
  (``encoder.dense_bidirectional_attention``);
- a decoder block is self-attention -> MLP (the shared body, unchanged),
  then the cross branch as its own pre-normed residual read of the memory
  (``_cross_attend``, no rope: source and target positions live in
  different sequences);
- generation encodes the source once and projects each layer's cross K/V
  once (``memory_projections``); the cached loop then runs one T=1 block
  pass per layer and step through the self-attention KV cache
  (``decoder_forward_chunk`` over ``decode._decode_block``), pinned
  against a full-recompute reference (``cached=False``).

Over a mesh (``init_seq2seq_state(..., mesh=)``,
``make_seq2seq_train_step(..., mesh=)``) both stacks take training's specs
and the cross branch shards its heads on tp like self-attention
(``seq2seq_param_specs``: ``wo_x`` row-parallel, a ``reduce_from`` after
it). The batch goes on dp and both sequences on sp, so a rank holds a block
of the source and of the target: the encoder's bidirectional attention and
the cross branch read every source position through a non-causal ring,
the decoder's self-attention through the causal ring (both the dense ring:
the seq2seq attention is dense on one card too).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import decode as decode_lib
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs import train as train_lib
from kubetpu_torch.jobs.encoder import dense_bidirectional_attention
from kubetpu_torch.jobs.model import (ModelConfig, Transformer, _param,
                                      resolve_device)
from kubetpu_torch.jobs.ring_attention import make_ring_attention
from kubetpu_torch.jobs.train import (AdamW, TrainState, _uploader,
                                      make_optimizer, make_update_step,
                                      state_from_params)

CROSS_LEAVES = ("ln_x", "wq_x", "wk_x", "wv_x", "wo_x")


class CrossBlock(model_lib.Block):
    """A decoder block: ``model.Block``'s leaves plus the cross branch's
    ``ln_x (d,)``, ``wq_x (d, H, hd)``, ``wk_x``/``wv_x (d, H_kv, hd)`` and
    ``wo_x (H, hd, d)``, in the JAX package's layouts (a tp rank's
    ``H/tp`` and ``H_kv/tp`` of the heads with ``tp > 1``)."""

    def __init__(self, cfg: ModelConfig, device, tp: int = 1,
                 ep: int = 1) -> None:
        super().__init__(cfg, device, tp, ep)
        d, h, hd, kv = (cfg.d_model, cfg.n_heads // tp, cfg.head_dim,
                        cfg.kv_heads // tp)
        self.ln_x = _param((d,), cfg, device)
        self.wq_x = _param((d, h, hd), cfg, device)
        self.wk_x = _param((d, kv, hd), cfg, device)
        self.wv_x = _param((d, kv, hd), cfg, device)
        self.wo_x = _param((h, hd, d), cfg, device)


class Seq2Seq(nn.Module):
    """``encoder``: a ``Transformer`` without its head (embed, blocks,
    ln_f); ``decoder``: a ``Transformer`` whose blocks are
    ``CrossBlock``s. Constructed with uninitialized weights;
    ``init_seq2seq_params`` or ``convert.seq2seq_params_from_numpy`` fill
    them. With ``tp``/``ep`` > 1 it holds one rank's shard
    (``seq2seq_param_specs``), and ``shard`` is its
    ``collectives.ModelShard``."""

    shard: Optional[col.ModelShard] = None

    def __init__(self, cfg: ModelConfig, device, tp: int = 1,
                 ep: int = 1) -> None:
        super().__init__()
        self.cfg = cfg
        self.encoder = Transformer(cfg, device, tp=tp, ep=ep)
        del self.encoder.head                  # memory, not logits
        self.decoder = Transformer(cfg, device, tp=tp, ep=ep)
        self.decoder.blocks = nn.ModuleList(
            [CrossBlock(cfg, device, tp, ep) for _ in range(cfg.n_layers)])


def seq2seq_plan(model: Seq2Seq):
    """Every leaf of a whole ``Seq2Seq`` with its scale, in
    ``init_seq2seq_params``' draw order (``model.fill_plan``)."""
    cfg = model.cfg
    scale = cfg.d_model ** -0.5
    for stack in (model.encoder, model.decoder):
        yield from model_lib.blocks_plan(stack.blocks, cfg)
        yield from ((stack.embed, scale), (stack.ln_f, None))
    yield model.decoder.head, scale
    for blk in model.decoder.blocks:
        yield from ((blk.ln_x, None), (blk.wq_x, scale), (blk.wk_x, scale),
                    (blk.wv_x, scale),
                    (blk.wo_x, (cfg.n_heads * cfg.head_dim) ** -0.5))


def init_seq2seq_params(generator: torch.Generator, cfg: ModelConfig,
                        device=None) -> Seq2Seq:
    """Random weights with ``kubetpu.jobs.seq2seq.init_seq2seq_params``'s
    shapes and scales: both stacks by ``model.init_params``'s rule (the
    encoder without a head), the cross branch like self-attention (``ln_x``
    at 1, ``d**-0.5``, ``(H*hd)**-0.5`` for ``wo_x``); drawn from
    *generator*, which must live on *device* (the card by default)."""
    device = resolve_device(device)
    model = Seq2Seq(cfg, device)
    model_lib.fill_plan(seq2seq_plan(model), model_lib.normal_filler(
        generator, cfg.dtype, device))
    return model


def seq2seq_param_specs(cfg: ModelConfig) -> dict:
    """The axis each dimension of each leaf shards on: training's specs
    for both stacks (``train.param_specs``, the encoder without a head),
    the cross projections' heads on tp like self-attention's."""
    enc = train_lib.param_specs(cfg)
    del enc["head"]
    dec = train_lib.param_specs(cfg)
    dec["blocks"] = dict(dec["blocks"], ln_x=(None, None),
                         wq_x=(None, None, "tp", None),
                         wk_x=(None, None, "tp", None),
                         wv_x=(None, None, "tp", None),
                         wo_x=(None, "tp", None, None))
    return {"encoder": enc, "decoder": dec}


def init_seq2seq_shard(generator: torch.Generator, cfg: ModelConfig, mesh,
                       device=None) -> Seq2Seq:
    """This rank's shard of ``init_seq2seq_params(generator, cfg)``, drawn
    leaf by leaf (``train.draw_shard``: the shard plus one whole leaf at
    a time, equal bit for bit to cutting the whole model)."""
    device = resolve_device(device)
    train_lib.check_mesh(cfg, mesh)
    local = Seq2Seq(cfg, device, tp=col.axis_size(mesh, "tp"),
                    ep=col.axis_size(mesh, "ep"))
    whole = Seq2Seq(cfg, torch.device("meta"))
    specs = seq2seq_param_specs(cfg)
    train_lib.draw_shard(seq2seq_plan(whole), train_lib.shard_routes(
        whole, local, specs, mesh), generator, cfg.dtype, device, mesh)
    local.shard = col.model_shard(mesh, specs, moe=cfg.n_experts > 0)
    return local


def _cross_attend(cfg: ModelConfig, h: torch.Tensor, layer: CrossBlock,
                  mem_k: torch.Tensor, mem_v: torch.Tensor) -> torch.Tensor:
    """Full-visibility attention of decoder states h (B, T, D) over the
    memory projections mem_k / mem_v (B, S, H_kv, hd) -> (B, T, D)."""
    q = torch.einsum("btd,dhk->bthk", h, layer.wq_x)
    n_rep = cfg.n_heads // cfg.kv_heads
    attn = dense_bidirectional_attention(
        q, model_lib.repeat_kv(mem_k, n_rep), model_lib.repeat_kv(mem_v, n_rep))
    return torch.einsum("bthk,hkd->btd", attn, layer.wo_x)


def memory_projections(cfg: ModelConfig, dec_blocks, memory: torch.Tensor):
    """Every layer's cross K/V of the encoder memory (B, S, D): a pair of
    (L, B, S, H_kv, hd) tensors, computed once per encode; the decode
    loop's cross branch is then a read."""
    k = torch.stack([torch.einsum("bsd,dhk->bshk", memory, blk.wk_x)
                     for blk in dec_blocks])
    v = torch.stack([torch.einsum("bsd,dhk->bshk", memory, blk.wv_x)
                     for blk in dec_blocks])
    return k, v


def encode(params: Seq2Seq, src: torch.Tensor, cfg: ModelConfig,
           attn_fn=None, return_aux: bool = False):
    """Source tokens (B, S) -> memory (B, S, D) through the bidirectional
    stack; with ``return_aux`` also the encoder's summed MoE load-balance
    term."""
    mem, aux = model_lib.forward_hidden(
        params.encoder, src, cfg,
        attn_fn=attn_fn or dense_bidirectional_attention)
    return (mem, aux) if return_aux else mem


def _cross_block(cfg, attn_fn, positions, x, layer_and_memory):
    """One decoder block -> (x, aux): the shared self-attention + MLP body,
    then the cross branch over the layer's (mem_k, mem_v)."""
    layer, mem_k, mem_v = layer_and_memory
    x, aux, _k, _v = model_lib._block_with_aux(cfg, attn_fn, positions, x,
                                               layer)
    h = model_lib.rms_norm(x, layer.ln_x)
    return x + _cross_attend(cfg, h, layer, mem_k, mem_v), aux


def decoder_forward(params: Seq2Seq, tgt_in: torch.Tensor,
                    memory: torch.Tensor, cfg: ModelConfig, attn_fn=None,
                    positions: Optional[torch.Tensor] = None,
                    return_aux: bool = False, return_hidden: bool = False):
    """Teacher-forced decoder logits (B, T, V) in ``cfg.dtype``,
    differentiable: causal self-attention over *tgt_in* (banded by
    ``cfg.window``, as the cached generate bands its cache read) plus
    cross-attention into *memory* in every block, each block with its cross
    branch recomputed in the backward under ``cfg.remat``. With
    ``return_aux`` also the decoder's summed MoE load-balance term; with
    ``return_hidden`` the final-norm hidden states (B, T, D) and the aux
    term instead of logits (the chunked loss tail reads these)."""
    dec = params.decoder
    if attn_fn is None:
        attn_fn = model_lib.default_attn_fn(cfg)
    if positions is None:
        positions = torch.arange(tgt_in.shape[1], dtype=torch.int32,
                                 device=tgt_in.device)
    mem_k, mem_v = memory_projections(cfg, dec.blocks, memory)
    x, aux = model_lib.run_blocks(cfg, attn_fn, positions, dec.embed[tgt_in],
                                  zip(dec.blocks, mem_k, mem_v),
                                  body=_cross_block)
    x = model_lib.rms_norm(x, dec.ln_f)
    if return_hidden:
        return x, aux
    logits = torch.einsum("btd,dv->btv", x, dec.head)
    return (logits, aux) if return_aux else logits


def seq2seq_loss(params: Seq2Seq, src: torch.Tensor, tgt_in: torch.Tensor,
                 tgt_out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of *tgt_out* given (src, tgt_in); MoE
    configs add ``moe_aux_coeff`` times the load-balance term of both
    stacks."""
    memory, aux_enc = encode(params, src, cfg, return_aux=True)
    x, aux_dec = decoder_forward(params, tgt_in, memory, cfg,
                                 return_hidden=True)
    loss = model_lib.lm_loss_tail(x, params.decoder.head, tgt_out, cfg)
    if cfg.moe_aux_coeff > 0:
        loss = loss + cfg.moe_aux_coeff * (aux_enc + aux_dec)
    return loss


def seq2seq_mesh_parts(cfg: ModelConfig, mesh):
    """(loss_fn, sync) of the sharded seq2seq step on *mesh*: this rank's
    block of source and target (rows on the data axes, positions on sp,
    RoPE at their global positions), the encoder under the non-causal
    ring, the decoder's self-attention under the causal ring and its
    cross branch over every source position through the non-causal ring,
    the vocab-parallel loss tail; gradients summed over the data axes and
    sp."""
    groups = col.groups_of(mesh)
    shard = train_lib.step_shard(cfg, groups)
    tp = shard.tp
    spec = train_lib.batch_spec(mesh)
    sp_index = col.axis_index(mesh, "sp")
    causal = make_ring_attention(mesh, impl="dense", window=cfg.window)
    bidir = make_ring_attention(mesh, impl="dense", causal=False)
    n_rep = cfg.n_heads // cfg.kv_heads

    def cross_block(cfg, attn_fn, positions, x, layer_and_memory):
        layer, mem_k, mem_v = layer_and_memory
        x, aux, _k, _v = model_lib._block_with_aux(cfg, attn_fn, positions,
                                                   x, layer, shard)
        h = col.copy_to(model_lib.rms_norm(x, layer.ln_x), tp)
        q = torch.einsum("btd,dhk->bthk", h, layer.wq_x)
        attn = bidir(q, model_lib.repeat_kv(mem_k, n_rep),
                     model_lib.repeat_kv(mem_v, n_rep))
        return x + col.reduce_from(
            torch.einsum("bthk,hkd->btd", attn, layer.wo_x), tp), aux

    def loss_fn(params, src, tgt_in, tgt_out):
        src, tgt_in, tgt_out = (train_lib._take(x, spec, mesh)
                                for x in (src, tgt_in, tgt_out))
        enc, dec = params.encoder, params.decoder
        memory, aux_enc = model_lib.run_blocks(
            cfg, bidir, train_lib._positions(sp_index, src.shape[1],
                                             src.device),
            enc.embed[src], enc.blocks,
            body=partial(model_lib._block_output, shard=shard))
        memory = col.copy_to(model_lib.rms_norm(memory, enc.ln_f), tp)
        mem_k, mem_v = memory_projections(cfg, dec.blocks, memory)
        x, aux_dec = model_lib.run_blocks(
            cfg, causal, train_lib._positions(sp_index, tgt_in.shape[1],
                                              tgt_in.device),
            dec.embed[tgt_in], zip(dec.blocks, mem_k, mem_v),
            body=cross_block)
        x = model_lib.rms_norm(x, dec.ln_f)
        loss = train_lib.sharded_loss_tail(x, dec.head, tgt_out, None, cfg,
                                           groups)
        if cfg.moe_aux_coeff > 0:
            loss = loss + cfg.moe_aux_coeff * (aux_enc + aux_dec)
        return loss

    specs = seq2seq_param_specs(cfg)
    local = Seq2Seq(cfg, torch.device("meta"), tp=col.axis_size(mesh, "tp"),
                    ep=col.axis_size(mesh, "ep"))
    sync = train_lib.sync_for([(n, train_lib.leaf_spec(specs, n))
                               for n, _ in local.named_parameters()], groups)
    return loss_fn, sync


def make_seq2seq_train_step(cfg: ModelConfig,
                            optimizer: Optional[AdamW] = None,
                            accum_steps: int = 1, mesh=None, device=None):
    """``step(state, src, tgt_in, tgt_out) -> (state, loss)`` on *device*
    (the card by default); ``accum_steps > 1`` sums the gradients of that
    many microbatches (``train.make_update_step``). Batches may be numpy
    arrays (uploaded) or tensors already on the device. With *mesh* every
    rank passes the GLOBAL batch and ``init_seq2seq_state(...,
    mesh=)``'s state (``seq2seq_mesh_parts``)."""
    optimizer = optimizer or make_optimizer()
    up = _uploader(resolve_device(device))
    sync = None
    if mesh is None:
        def loss_fn(p, s, ti, to):
            return seq2seq_loss(p, s, ti, to, cfg)
    else:
        train_lib.check_mesh(cfg, mesh)
        loss_fn, sync = seq2seq_mesh_parts(cfg, mesh)
    step = make_update_step(loss_fn, optimizer, accum_steps=accum_steps,
                            sync=sync)

    def train_step(state: TrainState, src, tgt_in, tgt_out):
        return step(state, up(src, torch.int64), up(tgt_in, torch.int64),
                    up(tgt_out, torch.int64))

    return train_step


def init_seq2seq_state(generator: torch.Generator, cfg: ModelConfig,
                       optimizer: Optional[AdamW] = None, mesh=None,
                       device=None):
    """-> (TrainState, optimizer): random weights from *generator* on
    *device* (the card by default) and a zero AdamW state; with *mesh*,
    this rank's shard of them (``init_seq2seq_shard``)."""
    optimizer = optimizer or make_optimizer()
    if mesh is not None:
        params = init_seq2seq_shard(generator, cfg, mesh, device)
    else:
        params = init_seq2seq_params(generator, cfg, resolve_device(device))
    return state_from_params(params, optimizer), optimizer


@torch.no_grad()
def decoder_forward_chunk(cfg: ModelConfig, params: Seq2Seq, tokens, mem_k,
                          mem_v, k_cache, v_cache, pos):
    """A T-token chunk through the decoder's self-attention KV cache plus a
    cross read of the precomputed memory projections: the seq2seq
    counterpart of ``decode.forward_chunk`` (``decode._decode_block``, then
    the cross branch as in ``decoder_forward``). tokens (B, T) at
    pos..pos+T-1; caches (L, B, S_max, H_kv, D), written in place ->
    (logits (B, T, V) f32, k_cache, v_cache)."""
    dec = params.decoder
    x = dec.embed[tokens]
    for i, layer in enumerate(dec.blocks):
        x, _k, _v = decode_lib._decode_block(cfg, layer, x, k_cache[i],
                                             v_cache[i], pos)
        h = model_lib.rms_norm(x, layer.ln_x)
        x = x + _cross_attend(cfg, h, layer, mem_k[i], mem_v[i])
    return decode_lib._head(dec, x), k_cache, v_cache


def make_seq2seq_generate(cfg: ModelConfig, bos_id: int = 1,
                          eos_id: Optional[int] = None, cached: bool = True,
                          device=None):
    """Greedy ``generate(params, src (B, S), num_steps) -> (B, num_steps)``
    target tokens (int64) on *device* (the card by default). The source is
    encoded once. ``cached=True`` decodes through the self-attention KV
    cache with the cross K/V projected once: one T=1 block pass per layer
    and step. ``cached=False`` re-runs the decoder over the whole prefix
    every step (the reference the cached path is pinned against). With
    *eos_id*, a row that emits it keeps emitting it."""
    dev = resolve_device(device)

    @torch.no_grad()
    def generate(params: Seq2Seq, src, num_steps: int) -> torch.Tensor:
        src = torch.as_tensor(src).to(dev)
        b = src.shape[0]
        memory = encode(params, src, cfg)
        if cached:
            mem_k, mem_v = memory_projections(cfg, params.decoder.blocks,
                                              memory)
            caches = decode_lib.init_kv_cache(cfg, b, num_steps + 1,
                                              device=dev)

            def next_logits(i, prev):
                logits, _k, _v = decoder_forward_chunk(
                    cfg, params, prev[:, None], mem_k, mem_v, *caches, i)
                return logits[:, 0]
        else:
            out = torch.full((b, num_steps + 1), bos_id, dtype=torch.int64,
                             device=dev)

            def next_logits(i, prev):
                out[:, i] = prev
                return decoder_forward(params, out, memory, cfg)[:, i]

        prev = torch.full((b,), bos_id, dtype=torch.int64, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        picks = [torch.zeros((b, 0), dtype=torch.int64, device=dev)]
        for i in range(num_steps):
            prev = torch.argmax(next_logits(i, prev), dim=-1)
            if eos_id is not None:
                prev = torch.where(done, eos_id, prev)
                done = done | (prev == eos_id)
            picks.append(prev[:, None])
        return torch.cat(picks, dim=1)

    return generate
