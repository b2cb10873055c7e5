"""Ring attention: sequence-parallel attention over the ``sp`` sub-group of a
mesh (port of ``kubetpu/jobs/ring_attention.py``) — causal by default,
bidirectional with ``causal=False``.

The sequence is sharded over the ring: rank i of the ``sp`` group holds
query, key and value block i (its ``S_local`` contiguous positions) and
the key/value blocks rotate one hop a step, so that peak activation memory
stays O(S / sp) for exact attention. Every core here runs on this rank's
LOCAL block: ``(B, S_local, H, D)`` in and out (where the JAX package's
``shard_map`` takes the global arrays).

Three bodies:

- ``_ring_attention_local``: the dense ring, plain tensor ops. f32 scores
  per block pair and a running max and normalizer; gradients through
  autograd and ``collectives.ring_shift`` (the gradient hops back).
- ``_ring_banded_local``: the banded ring (sliding window). With
  ``window <= S_local`` a query's band lies in its own block plus the last
  ``window - 1`` keys of its left neighbour's, so the rotation becomes one
  boundary exchange of that tail; rank 0's wrapped tail is masked by global
  position.
- ``_RingFlash``: the flash ring, a ``torch.autograd.Function`` that runs
  the port's flash kernels in every ring step (``ops.flash_attention``:
  the CUDA kernels for CUDA tensors, their plain versions for CPU
  tensors). Forward: step 0 is the diagonal block (causal for a causal
  ring); each later step rotates K/V one hop and runs
  ``flash_forward(causal=False)`` on the visiting block; blocks merge
  through the log-sum-exp. Backward: step 0 runs ``flash_backward`` with
  the GLOBAL out and lse; then (k, v, dk, dv) travel the ring together,
  dQ accumulates locally, and one more hop brings dK/dV home. A causal
  ring skips the kernels on a block that lies in the future (step t >
  my index) but never the hop: every rank issues the same sequence of
  sends and receives.
"""

from __future__ import annotations

from functools import partial

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.ops import flash_attention as fa

NEG_INF = -1e30


def _ring_index(group):
    import torch.distributed as dist

    if group is None:
        return 0, 1
    return (dist.get_group_rank(group, dist.get_rank()),
            dist.get_world_size(group))


def _ring_attention_local(q, k, v, group, causal: bool = True):
    """The dense ring on this rank's blocks, (B, S_local, H, D)."""
    my_idx, sp_size = _ring_index(group)
    b, s_local, h, d = q.shape
    scale = d ** -0.5
    q32 = q.float()
    local_pos = torch.arange(s_local, device=q.device)
    o = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(sp_size):
        # after t hops this rank holds block (my_idx - t)
        src_idx = (my_idx - t) % sp_size
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        if causal:
            q_pos = my_idx * s_local + local_pos
            k_pos = src_idx * s_local + local_pos
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        if causal:
            # exp under the mask: a block with nothing visible yet would
            # give exp(NEG_INF - NEG_INF) = 1
            p = torch.where(mask, p, 0.0)
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if t + 1 < sp_size:
            k_blk = col.ring_shift(k_blk, group)
            v_blk = col.ring_shift(v_blk, group)
    out = o / l[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ring_banded_local(q, k, v, group, window: int):
    """The banded ring: one boundary exchange of the left neighbour's last
    ``window - 1`` keys, then an exact banded softmax in f32."""
    my_idx, _sp_size = _ring_index(group)
    b, s_local, h, d = q.shape
    if window > s_local:
        raise ValueError(
            f"banded ring needs window <= S/sp ({window} > {s_local}): "
            f"lower sp, shorten the window, or use the full ring "
            f"(window=0)")
    tail = window - 1
    if tail > 0:
        left_k = col.ring_shift(k[:, s_local - tail:], group)
        left_v = col.ring_shift(v[:, s_local - tail:], group)
        kk = torch.cat([left_k, k], dim=1)
        vv = torch.cat([left_v, v], dim=1)
    else:
        kk, vv = k, v
    scale = d ** -0.5
    q_pos = my_idx * s_local + torch.arange(s_local, device=q.device)
    k_pos = (my_idx * s_local - tail
             + torch.arange(s_local + tail, device=q.device))
    diff = q_pos[:, None] - k_pos[None, :]
    # k_pos >= 0 drops rank 0's wrapped tail (the sequence end's keys)
    mask = (diff >= 0) & (diff < window) & (k_pos[None, :] >= 0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vv.float())
    return out.to(q.dtype)


def _merge_weight(w, b, h, s_local):
    """(B*H, S, 1) lse-space weight -> (B, S, H, 1) activation layout."""
    return w.reshape(b, h, s_local, 1).permute(0, 2, 1, 3)


def _visible(t: int, my_idx: int, causal: bool) -> bool:
    """After t hops rank my_idx holds block my_idx - t: a causal ring sees
    it iff t <= my_idx (wrapped blocks are future positions)."""
    return t <= my_idx if causal else True


class _RingFlash(torch.autograd.Function):
    """The flash ring; saves (q, k, v, out, lse) with the global lse."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        my_idx, sp_size = _ring_index(group)
        b, s_local, h, _d = q.shape
        o0, lse = fa.flash_forward(q, k, v, causal=causal)
        o_acc = o0.float()
        k_blk, v_blk = k, v
        for t in range(1, sp_size):
            k_blk, v_blk = col.hop([k_blk, v_blk], group, "sp")
            if not _visible(t, my_idx, causal):
                continue
            o_t, lse_t = fa.flash_forward(q, k_blk, v_blk, causal=False)
            lse_new = torch.logaddexp(lse, lse_t)
            o_acc = (o_acc * _merge_weight(torch.exp(lse - lse_new), b, h,
                                           s_local)
                     + o_t.float() * _merge_weight(torch.exp(lse_t - lse_new),
                                                   b, h, s_local))
            lse = lse_new
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        g = g.to(q.dtype).contiguous()
        my_idx, sp_size = _ring_index(group)
        dq, dk, dv = fa.flash_backward(q, k, v, out, lse, g, causal=causal)
        dq, dk_blk, dv_blk = dq.float(), dk.float(), dv.float()
        k_blk, v_blk = k, v
        for t in range(1, sp_size):
            # the (k, v, dk, dv) quad travels together
            k_blk, v_blk, dk_blk, dv_blk = col.hop(
                [k_blk, v_blk, dk_blk, dv_blk], group, "sp")
            if not _visible(t, my_idx, causal):
                continue
            dq_t, dk_t, dv_t = fa.flash_backward(q, k_blk, v_blk, out, lse,
                                                 g, causal=False)
            dq = dq + dq_t.float()
            dk_blk = dk_blk + dk_t.float()
            dv_blk = dv_blk + dv_t.float()
        if sp_size > 1:
            # sp - 1 hops leave the quad one hop short of home
            dk_blk, dv_blk = col.hop([dk_blk, dv_blk], group, "sp")
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None)


def make_ring_local(impl: str, group, causal: bool = True, window: int = 0):
    """The per-rank ring body (q, k, v) -> out over the sub-group *group*
    (None: a ring of one), the one place the impl dispatch lives.
    ``impl`` is "dense" or "flash"; ``causal=False`` is the bidirectional
    ring; ``window > 0`` selects the banded ring for both impls (the band
    is too narrow for per-step flash kernels to pay for themselves)."""
    if impl not in ("dense", "flash"):
        raise ValueError(f"unknown ring impl {impl!r} (expected 'dense' or "
                         "'flash')")
    if window > 0:
        if not causal:
            raise ValueError("window > 0 requires causal attention")
        return partial(_ring_banded_local, group=group, window=window)
    if impl == "flash":
        return lambda q, k, v: _RingFlash.apply(q, k, v, group, causal)
    return partial(_ring_attention_local, group=group, causal=causal)


def make_ring_attention(mesh, axis_name: str = "sp", impl: str = "dense",
                        causal: bool = True, window: int = 0):
    """An attention core (q, k, v) -> out over *mesh*'s *axis_name* ring,
    drop-in for ``model.forward_hidden``'s ``attn_fn`` on this rank's
    sequence block (the caller gives each rank its block, and RoPE its
    global positions). ``impl="flash"`` runs the flash kernels in every
    ring step; ``causal=False`` is the bidirectional (encoder) ring;
    ``window > 0`` the banded ring."""
    return make_ring_local(impl, col.group_of(mesh, axis_name), causal,
                           window)
