"""Collectives over a DeviceMesh's sub-groups, and the autograd-aware ones
the sharded training step is built from.

What GSPMD inserts for the JAX package, the port calls by hand:

- ``copy_to`` / ``reduce_from``: the tensor-parallel pair. ``copy_to`` is
  the identity forward and an all-reduce of the gradient backward (before a
  column-parallel product, whose input is replicated); ``reduce_from``
  all-reduces forward and passes the gradient through backward (after a
  row-parallel product, and around every partial sum of a value all ranks
  then use alike: the vocab-parallel loss tail, the global mean loss).
- ``ring_shift``: one hop around a ring (rank i's tensor to rank i+1),
  differentiable (the gradient hops back).
- ``hop``: the hop without autograd, several tensors at once, for the
  flash ring's own backward.
- ``send_to`` / ``recv_from``, ``broadcast_``, ``all_reduce_`` and
  ``all_gather``: the pipeline's, the optimizer's and the tests'.
- ``ModelShard``: the groups a sharded model's forward reduces over (tp,
  the MoE experts' tp x ep, the data axes a capacity dispatch spans),
  which ``train.shard_model`` attaches to the shard it cuts.

Every hop is ``batch_isend_irecv``: each rank posts its send and its
receive together, so no ring deadlocks on blocking sends.

The backend is the process group's (``launch.initialize_distributed``
names it). Under NCCL, one rank a GPU, CUDA tensors go device to device.
Under gloo (the one-card world of N ranks time-sharing ``cuda:0``, where
NCCL refuses two ranks on one device), gloo takes CUDA tensors only for
the operations in ``GLOO_CUDA_OPS`` (``scripts/torch_gloo_probe.py`` lists
what the installed torch takes); every other operation on CUDA tensors
goes through ``stage_through_host``, the one function that copies them to
pinned host buffers and back: the point-to-point hops of the rings and
the pipeline.

Counters (plain integers, reset by the caller): ``axis_bytes[label]``,
the payload bytes this rank sent or reduced, by the label its caller gave
("sp", "tp", "dp", "pp"); ``stage_through_host.bytes``, the bytes copied
between the card and pinned host memory, both ways.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the operations gloo takes on CUDA tensors, f32 and bf16, in the torch on
# the card (2.11, scripts/torch_gloo_probe.py): all_reduce, broadcast and
# all_gather (reduce_scatter too, unused here). send/recv and
# batch_isend_irecv hand gloo the device pointer (writev: Bad address) and
# are staged through the host
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

axis_bytes: Dict[str, int] = collections.Counter()
_PINNED: Dict[Tuple, torch.Tensor] = {}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(op: str, group, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether *op* on *tensors* over *group* goes through the host."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def _pinned(t: torch.Tensor, slot) -> torch.Tensor:
    key = (t.dtype, t.numel(), slot)
    buf = _PINNED.get(key)
    if buf is None:
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        _PINNED[key] = buf
    return buf.view(t.shape)


def stage_through_host(run: Callable[[List[torch.Tensor]], None],
                       tensors: Sequence[torch.Tensor],
                       modes: Sequence[str]) -> None:
    """Run ``run(host)`` on pinned host stand-ins of the CUDA *tensors*:
    mode "in" copies the tensor to its stand-in first, "out" copies the
    stand-in back after, "inout" both. The card's stream is synchronized
    before *run* (the copies have landed) and the copies back are queued
    on it. Pinned buffers are kept per (dtype, size, slot) and reused."""
    host = [_pinned(t, (i, m)) for i, (t, m) in enumerate(zip(tensors,
                                                              modes))]
    moved = 0
    for t, h, m in zip(tensors, host, modes):
        if m in ("in", "inout"):
            h.copy_(t, non_blocking=True)
            moved += t.numel() * t.element_size()
    torch.cuda.current_stream().synchronize()
    run(host)
    for t, h, m in zip(tensors, host, modes):
        if m in ("out", "inout"):
            t.copy_(h, non_blocking=True)
            moved += t.numel() * t.element_size()
    stage_through_host.bytes += moved


stage_through_host.bytes = 0


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def all_reduce_(t: torch.Tensor, group, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of contiguous *t* over *group* (no-op for a
    group of one)."""
    if group_size(group) == 1:
        return t
    axis_bytes[axis] += _nbytes([t])
    if _staged("all_reduce", group, [t]):
        stage_through_host(
            lambda h: dist.all_reduce(h[0], op=op, group=group), [t],
            ["inout"])
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group, axis: str) -> torch.Tensor:
    """In-place broadcast of contiguous *t* from global rank *src*."""
    if group_size(group) == 1:
        return t
    axis_bytes[axis] += _nbytes([t])
    if _staged("broadcast", group, [t]):
        stage_through_host(
            lambda h: dist.broadcast(h[0], src=src, group=group), [t],
            ["inout"])
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along *dim*, in group-rank
    order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(n)]
    axis_bytes[axis] += _nbytes([t])
    if _staged("all_gather", group, [t]):
        stage_through_host(
            lambda h: dist.all_gather(h[1:], h[0], group=group),
            [t] + outs, ["in"] + ["out"] * n)
    else:
        dist.all_gather(outs, t, group=group)
    return torch.cat(outs, dim=dim)


def _p2p(sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """Post every send and receive at once (``batch_isend_irecv``) and
    wait for all; peers are global ranks, tags the position in each
    list."""
    def run(send_ts, recv_ts):
        ops = [dist.P2POp(dist.isend, t, peer, group, i)
               for i, (t, (_, peer)) in enumerate(zip(send_ts, sends))]
        ops += [dist.P2POp(dist.irecv, t, peer, group, i)
                for i, (t, (_, peer)) in enumerate(zip(recv_ts, recvs))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    tensors = [t for t, _ in sends] + [t for t, _ in recvs]
    if _staged("p2p", group, tensors):
        n = len(sends)
        stage_through_host(lambda h: run(h[:n], h[n:]), tensors,
                           ["in"] * n + ["out"] * len(recvs))
    else:
        run([t for t, _ in sends], [t for t, _ in recvs])


def ring_peers(group, shift: int = 1) -> Tuple[int, int]:
    """(global rank this rank sends to, global rank it receives from) for
    a hop of *shift* places around *group*'s ring."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    return (dist.get_global_rank(group, (me + shift) % n),
            dist.get_global_rank(group, (me - shift) % n))


def hop(tensors: Sequence[torch.Tensor], group, axis: str,
        shift: int = 1) -> List[torch.Tensor]:
    """Each tensor moved *shift* places around the ring (rank i's to rank
    i + shift): the tensors this rank receives, same shapes and dtypes."""
    if group_size(group) == 1:
        return list(tensors)
    nxt, prv = ring_peers(group, shift)
    tensors = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in tensors]
    axis_bytes[axis] += _nbytes(tensors)
    _p2p([(t, nxt) for t in tensors], [(g, prv) for g in got], group)
    return got


def send_to(t: torch.Tensor, peer: int, group, axis: str) -> None:
    """Send contiguous *t* to global rank *peer* (waits for the send)."""
    axis_bytes[axis] += _nbytes([t])
    _p2p([(t.contiguous(), peer)], [], group)


def recv_from(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    """A tensor shaped like *like* received from global rank *peer*."""
    got = torch.empty_like(like, memory_format=torch.contiguous_format)
    _p2p([], [(got, peer)], group)
    return got


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group,
                           ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return all_reduce_(x.contiguous().clone(), group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, shift):
        ctx.group, ctx.axis, ctx.shift = group, axis, shift
        return hop([x], group, axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return hop([g], ctx.group, ctx.axis, -ctx.shift)[0], None, None, None


def copy_to(x: torch.Tensor, group, axis: str = "tp") -> torch.Tensor:
    """Identity forward; the gradient all-reduced over *group* backward."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group, axis)


def reduce_from(x: torch.Tensor, group,
                axis: str = "tp") -> torch.Tensor:
    """All-reduce (sum) over *group* forward; the gradient passes
    unchanged backward: every rank of the group then computes alike from
    the sum, and each keeps its own part's gradient."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group,
                                                              axis)


def ring_shift(x: torch.Tensor, group, axis: str = "sp",
               shift: int = 1) -> torch.Tensor:
    """Rank i's *x* arrives at rank i + shift; differentiable."""
    return x if group_size(group) == 1 else _RingShift.apply(x, group, axis,
                                                             shift)


def group_of(mesh, name: str):
    """*mesh*'s sub-group over axis *name*, or None when the mesh lacks
    the axis or it has size 1."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(name)) == 1:
        return None
    return mesh.get_group(name)


class MeshGroups:
    """The sub-groups of *mesh* the sharded step reduces over, made once:
    ``over(*axes)`` is the group of the ranks that differ only along
    *axes* (one axis: the mesh's own sub-group; several: one new group for
    each line of the grid, every rank making every group in the same
    order, as ``new_group`` requires), or None when they are one rank.
    Groups are made on first use; every rank runs the same program, so
    every rank makes them at the same point."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self._groups: Dict[Tuple[str, ...], object] = {}

    def over(self, *axes: str):
        axes = tuple(a for a in axes if axis_size(self.mesh, a) > 1)
        if len(axes) <= 1:
            return group_of(self.mesh, axes[0]) if axes else None
        if axes not in self._groups:
            names = list(self.mesh.mesh_dim_names)
            dims = [names.index(a) for a in axes]
            others = [d for d in range(len(names)) if d not in dims]
            n = 1
            for d in dims:
                n *= self.mesh.size(d)
            lines = self.mesh.mesh.permute(*others, *dims).reshape(-1, n)
            me = dist.get_rank()
            for line in lines.tolist():
                group = dist.new_group(line)
                if me in line:
                    self._groups[axes] = group
        return self._groups[axes]


_GROUPS: Dict[int, MeshGroups] = {}


def groups_of(mesh) -> MeshGroups:
    """The one ``MeshGroups`` of *mesh*, so that every user of a mesh
    shares its sub-groups (each made once, collectively)."""
    groups = _GROUPS.get(id(mesh))
    if groups is None or groups.mesh is not mesh:
        groups = _GROUPS[id(mesh)] = MeshGroups(mesh)
    return groups


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """What a rank's shard of a model reduces over in its forward:

    - ``tp``: the tensor-parallel group (``copy_to`` before q/k/v and the
      MLP's inputs, ``reduce_from`` after ``wo`` and the MLP, the LM
      head's vocab shards gathered into whole logits);
    - ``moe``: the group over tp x ep a mixture-of-experts MLP sums its
      partial outputs over (the rank's experts' ff shard), with
      ``ep_index`` / ``ep_size`` naming the rank's experts;
    - ``data``: the group over the data axes one MoE capacity dispatch
      spans (the JAX package dispatches over the global batch), its ranks
      ordered batch block-major: ``data_blocks`` = (batch blocks,
      sequence blocks). None where every call dispatches on its own rows;
    - ``mesh``, ``specs`` and ``pp``: the mesh the shard was cut on, the
      spec tree it was cut by (its family's ``param_specs``), and whether
      its layers are a pipeline stage's (what a sharded checkpoint reads
      to name each leaf and cut it).
    """

    tp: object = None
    moe: object = None
    ep_index: int = 0
    ep_size: int = 1
    data: object = None
    data_blocks: Tuple[int, int] = (1, 1)
    mesh: object = dataclasses.field(default=None, compare=False)
    specs: object = dataclasses.field(default=None, compare=False)
    pp: bool = False

    def __deepcopy__(self, memo):
        return self         # process groups are shared, never copied

    def with_data(self, groups: MeshGroups,
                  axes: Sequence[str]) -> "ModelShard":
        """This shard with its capacity dispatch spanning *axes* (the
        batch axes, then sp when listed)."""
        mesh = groups.mesh
        seq = axis_size(mesh, "sp") if "sp" in axes else 1
        total = 1
        for a in axes:
            total *= axis_size(mesh, a)
        return dataclasses.replace(self, data=groups.over(*axes),
                                   data_blocks=(total // seq, seq))


def model_shard(mesh, specs=None, moe: bool = False,
                data_axes: Sequence[str] = (), pp: bool = False
                ) -> ModelShard:
    """The ``ModelShard`` of *mesh* for a model cut by the spec tree
    *specs* (a mixture-of-experts model's when *moe*; a pipeline stage's
    when *pp*), its groups made now: every rank calls this at the same
    point. *data_axes*: the axes one MoE capacity dispatch spans."""
    groups = groups_of(mesh)
    shard = ModelShard(
        tp=groups.over("tp"),
        moe=groups.over("tp", "ep") if moe else None,
        ep_index=axis_index(mesh, "ep"), ep_size=axis_size(mesh, "ep"),
        mesh=mesh, specs=specs, pp=pp)
    return shard.with_data(groups, data_axes) if data_axes else shard


def axis_index(mesh, name: str) -> int:
    """This rank's index along axis *name* (0 when the mesh lacks it)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def reset_counters() -> None:
    axis_bytes.clear()
    stage_through_host.bytes = 0
