"""Pipeline parallelism: GPipe over a ``pp`` mesh axis, composing with dp, sp,
tp and ep (port of ``kubetpu/jobs/pipeline.py``).

Each pp rank holds one stage: ``n_layers / pp`` contiguous ``Block``s of
the model (``train.shard_model(..., pp=True)``), tp-sharded as in the
plain sharded step; the embedding, the final norm and the head are held by
every stage. The schedule is GPipe's: every microbatch through every
stage forward, then every microbatch back. The forward is written out
(stage p receives microbatch m from stage p - 1, runs its blocks, sends
the result to p + 1) and the backward is autograd's: the point-to-point
hops are autograd functions (``_RecvPrev``: the gradient goes back to the
previous stage; ``_SendNext``: the gradient comes back from the next one),
and autograd runs the microbatches' backward chains in reverse order of
creation on every stage, so the hops pair up. The last stage's output
reaches every pp rank by a broadcast (the reference's psum over pp), where
the loss tail runs alike on every stage, outside the stages. sp composes:
the ring runs inside each stage, over the stage's own sp group. The
reference's loss and update are the bar, not its tick order.

Microbatch m is the reference's: rows ``m*b .. (m+1)*b - 1`` of the global
batch, each data rank holding its block of every microbatch
(``pipeline_rows``). A mixture-of-experts stage runs its experts over ep
(``collectives.ModelShard``), a capacity dispatch spanning the
microbatch's rows over the data axes and each sp block on its own, as the
reference's region (manual over pp and sp, automatic over dp) computes
it; the reference's pipeline loss has no load-balance term, nor has this
one.

Two anchors keep autograd's pruning from skipping a hop: the embedding is
the input of ``_RecvPrev`` on every stage but the first (its gradient
there is zero; ``GradSync`` sums the embedding's gradient over pp), and
the ``_SendNext`` tokens (zeros) join the loss.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import model as model_lib
from kubetpu_torch.jobs import train as train_lib
from kubetpu_torch.jobs.model import ModelConfig, resolve_device, rms_norm
from kubetpu_torch.jobs.ring_attention import make_ring_local


class _RecvPrev(torch.autograd.Function):
    """Forward: the previous stage's activation; backward: its gradient
    sent back there (and a zero gradient for the anchor)."""

    @staticmethod
    def forward(ctx, anchor, like, prev, group):
        ctx.prev, ctx.group = prev, group
        ctx.anchor_shape, ctx.anchor_dtype = anchor.shape, anchor.dtype
        return col.recv_from(like, prev, group)

    @staticmethod
    def backward(ctx, g):
        col.send_to(g.contiguous(), ctx.prev, ctx.group, "pp")
        return (torch.zeros(ctx.anchor_shape, dtype=ctx.anchor_dtype,
                            device=g.device), None, None, None)


class _SendNext(torch.autograd.Function):
    """Forward: the activation sent to the next stage, a zero token out;
    backward: the activation's gradient received from there."""

    @staticmethod
    def forward(ctx, y, nxt, group):
        ctx.nxt, ctx.group = nxt, group
        ctx.save_for_backward(torch.empty(0, device=y.device))
        ctx.like = torch.empty_like(y, device="meta")
        col.send_to(y.contiguous(), nxt, group, "pp")
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        (anchor,) = ctx.saved_tensors
        like = torch.empty(ctx.like.shape, dtype=ctx.like.dtype,
                           device=anchor.device)
        return col.recv_from(like, ctx.nxt, ctx.group), None, None


def _stage_runner(cfg: ModelConfig, groups: col.MeshGroups,
                  n_microbatches: int, attn_fn):
    """``run(params, tokens) -> (final-norm hidden states of this rank's
    block, rows in microbatch order, on every pp rank; the zero tokens of
    the sends)``."""
    mesh = groups.mesh
    pp_group = groups.over("pp")
    n_stages = col.axis_size(mesh, "pp")
    stage = col.axis_index(mesh, "pp")
    first, last = stage == 0, stage == n_stages - 1
    nxt = prev = last_rank = None
    if pp_group is not None:
        import torch.distributed as dist

        nxt, prev = col.ring_peers(pp_group)
        last_rank = dist.get_global_rank(pp_group, n_stages - 1)
    body = partial(model_lib._block_output,
                   shard=train_lib.step_shard(cfg, groups, ("dcn", "dp")))
    sp_index = col.axis_index(mesh, "sp")

    def run(params, tokens):
        rows, s_local = tokens.shape
        if rows % n_microbatches:
            raise ValueError(f"this rank's {rows} rows do not split into "
                             f"{n_microbatches} microbatches")
        b = rows // n_microbatches
        positions = train_lib._positions(sp_index, s_local, tokens.device)
        like = torch.empty((b, s_local, cfg.d_model), dtype=cfg.dtype,
                           device=tokens.device)
        outs, sent = [], []
        for m in range(n_microbatches):
            if first:
                x = params.embed[tokens[m * b:(m + 1) * b]]
            else:
                x = _RecvPrev.apply(params.embed, like, prev, pp_group)
            y, _aux = model_lib.run_blocks(cfg, attn_fn, positions, x,
                                           params.blocks, body=body)
            if last:
                outs.append(y)
            else:
                sent.append(_SendNext.apply(y, nxt, pp_group))
        if last:
            h = torch.cat(outs)
            if pp_group is not None:
                col.broadcast_(h.detach().contiguous(), last_rank, pp_group,
                               "pp")
        else:
            h = col.broadcast_(torch.empty((rows, s_local, cfg.d_model),
                                           dtype=cfg.dtype,
                                           device=tokens.device),
                               last_rank, pp_group, "pp")
        return rms_norm(h, params.ln_f), sent

    return run


def pipeline_rows(x, mesh, n_microbatches: int):
    """This rank's block of a global (M*B, S) batch for the pipeline: of
    every microbatch (B consecutive rows) the rank's rows on the data
    axes, microbatch by microbatch, and its columns on sp. A block
    ``prefetch_to_mesh`` cut (consecutive rows) is refused: the pipeline
    takes the global batch."""
    if getattr(x, train_lib.LOCAL_BLOCK, False):
        raise ValueError("the pipeline takes the global batch, not "
                         "prefetch_to_mesh's blocks (its microbatches are "
                         "the reference's rows)")
    idx, n = train_lib._entry_index(mesh, train_lib.batch_spec(mesh)[0])
    rows, s = x.shape[0], x.shape[1]
    if rows % (n_microbatches * n):
        raise ValueError(f"{rows} rows do not split into {n_microbatches} "
                         f"microbatches over {n} data ranks")
    per = rows // (n_microbatches * n)
    x = x.reshape(n_microbatches, n, per, *x.shape[1:])[:, idx]
    x = x.reshape(n_microbatches * per, s, *x.shape[3:])
    return train_lib._take(x, (None, "sp"), mesh)


def _attention(cfg: ModelConfig, mesh, use_ring: bool, ring_impl: str):
    # built (and validated) even when use_ring is off, so a wrong impl
    # raises here
    ring = make_ring_local(ring_impl, col.group_of(mesh, "sp"),
                           window=cfg.window)
    if use_ring:
        return ring
    if col.axis_size(mesh, "sp") > 1:
        raise ValueError("use_ring=False on an sp > 1 mesh would attend "
                         "within each rank's block only")
    return model_lib.default_attn_fn(cfg)


def make_pipeline_forward(cfg: ModelConfig, mesh, n_microbatches: int,
                          use_ring: bool = True, ring_impl: str = "dense",
                          device=None):
    """``forward(params, tokens) -> logits`` through the pipeline: every
    rank passes the global (M*B, S) batch and gets its block's logits
    (``pipeline_rows``: of every microbatch its rows on the data axes, and
    its positions on sp) over the whole vocabulary;
    ``forward.hidden`` gives the final-norm hidden states instead. The
    embedding and the head run outside the stages. ``ring_impl="flash"``
    runs the flash kernels in every ring step."""
    train_lib.check_mesh(cfg, mesh, pp=True)
    up = train_lib._uploader(resolve_device(device))
    groups = col.groups_of(mesh)
    run = _stage_runner(cfg, groups, n_microbatches,
                        _attention(cfg, mesh, use_ring, ring_impl))

    @torch.no_grad()
    def forward_hidden(params, tokens):
        tokens = pipeline_rows(up(tokens, torch.int64), mesh, n_microbatches)
        return run(params, tokens)[0]

    @torch.no_grad()
    def forward(params, tokens):
        logits = torch.einsum("bsd,dv->bsv", forward_hidden(params, tokens),
                              params.head)
        return col.all_gather(logits, groups.over("tp"), "tp", dim=-1)

    forward.hidden = forward_hidden
    return forward


def pipeline_loss_fn(cfg: ModelConfig, groups: col.MeshGroups,
                     n_microbatches: int, use_ring: bool = True,
                     ring_impl: str = "dense"):
    """``loss_fn(params, tokens, targets)``: the global mean loss of the
    pipelined forward on this rank's block of the global batch, the loss
    tail on every stage; its gradient is this rank's part, before
    ``train.grad_sync``."""
    mesh = groups.mesh
    run = _stage_runner(cfg, groups, n_microbatches,
                        _attention(cfg, mesh, use_ring, ring_impl))

    def loss_fn(params, tokens, targets):
        tokens = pipeline_rows(tokens, mesh, n_microbatches)
        targets = pipeline_rows(targets, mesh, n_microbatches)
        x, sent = run(params, tokens)
        loss = train_lib.sharded_loss_tail(x, params.head, targets, None,
                                           cfg, groups)
        for token in sent:
            loss = loss + token
        return loss

    return loss_fn


def make_pipeline_train_step(cfg: ModelConfig, mesh, n_microbatches: int,
                             optimizer: Optional[train_lib.AdamW] = None,
                             use_ring: bool = True, ring_impl: str = "dense",
                             device=None):
    """The pipelined training step ``step(state, tokens, targets) ->
    (state, loss)``: GPipe forward and backward, the loss tail
    (``cfg.loss_chunk``, label smoothing and z-loss as in the plain step)
    on every stage, gradients summed over the data axes and sp (the
    embedding's over pp too), AdamW. Every rank passes the global batch
    and ``init_pipeline_state``'s state."""
    optimizer = optimizer or train_lib.make_optimizer()
    train_lib.check_mesh(cfg, mesh, pp=True)
    up = train_lib._uploader(resolve_device(device))
    groups = col.groups_of(mesh)
    step = train_lib.make_update_step(
        pipeline_loss_fn(cfg, groups, n_microbatches, use_ring, ring_impl),
        optimizer, sync=train_lib.grad_sync(cfg, groups, pp=True))

    def train_step(state, tokens, targets):
        return step(state, up(tokens, torch.int64), up(targets, torch.int64))

    return train_step


def init_pipeline_state(generator: torch.Generator, cfg: ModelConfig, mesh,
                        optimizer: Optional[train_lib.AdamW] = None,
                        device=None):
    """``train.init_state`` with the layers split over pp: this rank's
    stage of the one-card model of *generator*'s seed."""
    return train_lib.init_state(generator, cfg, optimizer, device, mesh=mesh,
                                pp=True)
