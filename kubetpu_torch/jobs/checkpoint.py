"""Checkpoint / resume for training jobs (port of
``kubetpu/jobs/checkpoint.py``).

The state is the port's ``train.TrainState``: the model's parameters, the
AdamW state (count, mu, nu) and the step. The format is the port's own: one
``state.pt`` in the checkpoint directory, ``torch.save`` of CPU tensors
(parameters by name, in the module's order), read back with
``torch.load(weights_only=True)``. The JAX package writes orbax directories;
what the two share is the behaviour, not the bytes.

Crash safety: every save writes to a TEMP sibling directory
(``<path>.tmp-<pid>``) and renames it into place only after the file was
flushed to disk — a job killed mid-save leaves a ``.tmp-*`` orphan, never a
half-written directory at the real path. ``latest_step_dir`` ignores
orphans (non-digit names). An overwritten checkpoint is first set aside as
``<path>.old``; a restore that finds only that generation restores it with
a warning. ``restore_checkpoint`` raises the typed ``CorruptCheckpointError``
for a missing, truncated, mangled or structurally mismatched checkpoint, so
resume logic can fall back to an older step.

``restore_checkpoint`` writes into the target state's own tensors, so the
result lands on the target's device in the target's dtypes: a checkpoint
written from the card restores onto the CPU and back.

On a mesh (a state whose model carries a ``ModelShard``: ``init_state(...,
mesh=)``, ``init_vit_state``, ``init_seq2seq_state``, the pipeline's) the
file is the same: the whole model's leaves under the whole model's names
(a pipeline stage's local block ``i`` is global layer ``stage_layers[i]``).
``save_checkpoint`` gathers it leaf by leaf, in the stored dtype, to one
writer rank (the mesh's first): each distinct slice of a leaf comes from
one rank (dp and sp replicas send nothing), no card holds a whole sharded
leaf, the writer's host holds the checkpoint as the one-device save does;
the writer commits, then every rank learns the outcome. A restore maps the
file (``torch.load(mmap=True)``), checks the whole model's names and
shapes against the target's, and copies into each of the target's tensors
only its rank's slice, so one-device and meshed checkpoints restore into
each other and into any mesh layout (tp, ep, pp).

Saves and restores are spanned (``checkpoint.save``,
``checkpoint.restore``) and logged (``checkpoint_save``,
``checkpoint_restore``) through the port's ``obs.trace`` and
``obs.events``.
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import List, Optional, Tuple

import itertools

import torch

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs import train as train_lib
from kubetpu_torch.jobs.train import TrainState

FORMAT = "kubetpu_torch.checkpoint/1"
STATE_FILE = "state.pt"


class CheckpointError(RuntimeError):
    """Base for checkpoint load/save failures."""


class CorruptCheckpointError(CheckpointError):
    """The checkpoint at this path is missing, truncated, or mangled —
    resume from an older step (``latest_step_dir`` of the parent) or
    restart from scratch."""


def _tmp_path(path: str) -> str:
    # sibling, same filesystem (os.replace must not cross devices); pid
    # disambiguates concurrent writers from different processes
    return f"{path}.tmp-{os.getpid()}"


def _commit(tmp: str, path: str) -> None:
    """Atomically move a finished write into place. An overwritten
    previous checkpoint is first set ASIDE (rename, not rmtree) so no
    crash window loses both generations: a kill between the two renames
    leaves the old checkpoint at ``<path>.old``, which
    ``restore_checkpoint`` falls back to."""
    old = path + ".old"
    had_old = False
    if os.path.isdir(path):
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(path, old)
        had_old = True
    os.replace(tmp, path)
    if had_old:
        shutil.rmtree(old, ignore_errors=True)


def _leaves(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of *state* in the file's order: the parameters, the
    count, the first moments, the second moments."""
    opt = state.opt_state
    return ([p for _n, p in state.params.named_parameters()]
            + [opt.count] + list(opt.mu) + list(opt.nu))


def _payload(state: TrainState, host: List[torch.Tensor],
             names: Optional[List[str]] = None) -> dict:
    """The object ``torch.save`` writes, over host copies *host* of
    ``_leaves(state)`` (a meshed state's gathered whole leaves under the
    whole model's *names*)."""
    if names is None:
        names = [n for n, _p in state.params.named_parameters()]
    n = len(names)
    return {"format": FORMAT, "step": int(state.step),
            "params": dict(zip(names, host[:n])), "count": host[n],
            "mu": host[n + 1:2 * n + 1], "nu": host[2 * n + 1:]}


# -- the layout of a state's model: one device, or a mesh's shard --------------


class _Layout:
    """Where the leaves of a state's model live: ``mesh`` (None on one
    device), and for every parameter of the whole model, in its order,
    its whole name, whole shape and dtype, its local spec (block leaves
    without their layer entry), the pipeline stage that holds it (None:
    every stage) and this rank's tensor (None where another stage holds
    it)."""

    def __init__(self, model: torch.nn.Module) -> None:
        shard = getattr(model, "shard", None)
        self.mesh = None if shard is None else shard.mesh
        local = dict(model.named_parameters())
        if self.mesh is None:
            self.leaves = [(n, tuple(p.shape), p.dtype,
                            (None,) * p.dim(), None, p)
                           for n, p in local.items()]
            return
        specs = shard.specs
        if specs is None:
            raise CheckpointError("the model's ModelShard names no spec "
                                  "tree: a shard is cut by its family's "
                                  "param_specs")
        whole = _whole_meta(model)
        pp = shard.pp
        n_local = len(model.blocks) if pp else 0
        stage = col.axis_index(self.mesh, "pp")
        by_global = {train_lib.global_name(n, stage * n_local): n
                     for n in local}
        self.leaves = []
        for name, p in whole.named_parameters():
            layer = _layer_of(name)
            mine = by_global.get(name)
            self.leaves.append((
                name, tuple(p.shape), p.dtype,
                train_lib.local_spec(specs, name),
                layer // n_local if pp and layer is not None else None,
                None if mine is None else local[mine]))

    @property
    def names(self) -> List[str]:
        return [leaf[0] for leaf in self.leaves]


def _layer_of(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[parts.index("blocks") + 1]) if "blocks" in parts \
        else None


def _whole_meta(model: torch.nn.Module) -> torch.nn.Module:
    """A meta-device model of the whole model's shapes, of *model*'s
    family (its parameter names and order are the file's)."""
    return type(model)(model.cfg, torch.device("meta"))


def _owners(mesh, spec, stage) -> List[Tuple[int, dict]]:
    """(global rank, coords) of the ranks that hold the distinct slices
    of a leaf with local *spec* (held by pipeline *stage*, or every stage
    when None): any index on the axes the spec names, 0 on the others
    (dp and sp replicas are not asked twice), in the grid's order."""
    names = list(mesh.mesh_dim_names)
    used = {a for entry in spec if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)}
    ranges = []
    for i, a in enumerate(names):
        if a in used:
            ranges.append(range(mesh.size(i)))
        elif a == "pp" and stage is not None:
            ranges.append(range(stage, stage + 1))
        else:
            ranges.append(range(1))
    out = []
    for at in itertools.product(*ranges):
        out.append((int(mesh.mesh[at]), dict(zip(names, at))))
    return out


def _writer(mesh) -> int:
    return int(mesh.mesh.reshape(-1)[0])


def _mesh_group(mesh):
    return col.groups_of(mesh).over(*mesh.mesh_dim_names)


def _gather_leaf(layout: _Layout, i: int, tensor_of, group):
    """Leaf *i* of a meshed model (``tensor_of(local tensor)`` picks the
    parameter itself or one of its moments) gathered whole into the
    writer's host memory, in its stored dtype -> the whole CPU tensor on
    the writer, None elsewhere. Every rank calls it for every leaf in the
    same order: an owner other than the writer sends its slice, the
    writer takes its own and receives the others', one at a time."""
    import torch.distributed as dist

    mesh = layout.mesh
    name, shape, dtype, spec, stage, local = layout.leaves[i]
    me, writer = dist.get_rank(), _writer(mesh)
    owners = _owners(mesh, spec, stage)
    if me != writer:
        if local is not None and any(r == me for r, _c in owners):
            col.send_to(tensor_of(local).detach().contiguous(), writer,
                        group, "checkpoint")
        return None
    whole = torch.empty(shape, dtype=dtype)
    for rank, coords in owners:
        index = train_lib._region(shape, spec, mesh, coords)
        if rank == me:
            piece = tensor_of(local).detach()
        else:
            like = torch.empty(whole[index].shape, dtype=dtype,
                               device=_device(layout))
            piece = col.recv_from(like, rank, group)
        whole[index] = piece.cpu()
    return whole


def _device(layout: _Layout) -> torch.device:
    return next(leaf[5] for leaf in layout.leaves
                if leaf[5] is not None).device


def _gather_state(state: TrainState, layout: _Layout):
    """A meshed state's leaves gathered whole to the writer, in the file's
    order (parameters, count, mu, nu) -> the list on the writer, None
    elsewhere."""
    import torch.distributed as dist

    group = _mesh_group(layout.mesh)
    opt = state.opt_state
    index = {id(p): j for j, p in enumerate(state.params.parameters())}

    def pick(moments):
        if moments is None:
            return lambda t: t
        return lambda t: moments[index[id(t)]]

    params, mu, nu = ([_gather_leaf(layout, i, pick(which), group)
                       for i in range(len(layout.leaves))]
                      for which in (None, opt.mu, opt.nu))
    if dist.get_rank() != _writer(layout.mesh):
        return None
    return params + [opt.count.detach().cpu()] + mu + nu


def _settle(layout: _Layout, ok: bool) -> None:
    """Every rank of the mesh learns whether the writer's part succeeded
    (a MIN over the mesh); the ranks other than the writer raise when it
    failed (the writer raises its own error)."""
    import torch.distributed as dist

    flag = torch.tensor([1.0 if ok else 0.0], device=_device(layout))
    col.all_reduce_(flag, _mesh_group(layout.mesh), "checkpoint",
                    op=dist.ReduceOp.MIN)
    if flag[0] < 1 and dist.get_rank() != _writer(layout.mesh):
        raise CheckpointError("the checkpoint's writer rank failed")


def _host_copies(leaves: List[torch.Tensor],
                 buffers: Optional[List[torch.Tensor]] = None):
    """Host copies of *leaves*, finished before this returns: device
    tensors into page-locked buffers (reused from *buffers* when their
    shapes and dtypes match), all copies queued, then one synchronization;
    host tensors cloned."""
    reuse = (buffers is not None and len(buffers) == len(leaves)
             and all(b.shape == t.shape and b.dtype == t.dtype
                     for b, t in zip(buffers, leaves)))
    out, on_card = [], False
    for i, t in enumerate(leaves):
        t = t.detach()
        if t.device.type == "cpu":
            out.append(t.clone())
            continue
        on_card = True
        buf = (buffers[i] if reuse else
               torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        buf.copy_(t, non_blocking=True)
        out.append(buf)
    if on_card:
        torch.cuda.synchronize()
    return out


def _write(directory: str, payload: dict) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, STATE_FILE), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())


def _emit(kind: str, **fields) -> None:
    from kubetpu_torch.obs.events import event_log

    event_log().emit(kind, **fields)


def _write_and_commit(path: str, payload: dict) -> None:
    tmp = _tmp_path(path)
    if os.path.isdir(tmp):  # stale orphan from a crashed writer: replace
        shutil.rmtree(tmp)
    try:
        _write(tmp, payload)
        _commit(tmp, path)
        _emit("checkpoint_save", path=path)
    finally:
        if os.path.isdir(tmp):  # failed before commit: no orphan leak
            shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write a TrainState to *path* (created if needed): temp-write +
    atomic rename, so a crash mid-save never leaves a torn checkpoint at
    the real path. Spanned (``checkpoint.save``). A meshed state is saved
    by every rank of its mesh together (each calls this with the same
    *path*): its leaves are gathered to the writer rank, which writes and
    commits; every rank returns once the outcome is known, and raises if
    the write failed."""
    from kubetpu_torch.obs import trace as obs_trace

    path = os.path.abspath(path)
    layout = _Layout(state.params)
    with obs_trace.span("checkpoint.save", path=path):
        if layout.mesh is None:
            _write_and_commit(path, _payload(
                state, _host_copies(_leaves(state))))
            return
        host = _gather_state(state, layout)
        err = None
        if host is not None:
            try:
                _write_and_commit(path, _payload(state, host, layout.names))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = e
        _settle(layout, err is None)
        if err is not None:
            raise err


class AsyncCheckpointer:
    """Non-blocking checkpointing for the train loop: ``save`` returns as
    soon as the state's tensors are copied to host memory, and a
    background thread writes the file, so training resumes while I/O
    drains — the step loop pays the device-to-host copy, not the
    filesystem.

    The copy is finished before ``save`` returns: the train step updates
    parameters and moments in place, so a writer that read the card's
    tensors after the next step began would write a torn checkpoint. Card
    tensors go into page-locked host buffers (kept and reused by the next
    save of the same structure) with one synchronization.

    One in-flight save at a time: a second ``save`` first waits for the
    previous one (bounding dirty state at one checkpoint). Use as a
    context manager or call ``close()`` — pending writes flush on exit.

    A meshed state: every rank calls ``save``, ``wait`` and ``close``
    together. ``save`` gathers the snapshot collectively (``save_checkpoint``'s
    gather, finished before it returns); only the writer rank's thread
    writes, and ``wait`` settles the outcome on every rank.

    Crash safety: the background write lands in a ``.tmp-*`` sibling and
    is renamed into place only once finished (at the next ``save``/
    ``wait``/``close``) — a crash mid-write leaves an ignored orphan,
    never a torn checkpoint at the real path.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[tuple] = None  # (tmp, final) awaiting commit
        self._buffers: Optional[List[torch.Tensor]] = None
        self._layout: Optional[_Layout] = None   # a meshed save to settle

    def _run(self, tmp: str, payload: dict) -> None:
        try:
            _write(tmp, payload)
        except BaseException as e:  # noqa: BLE001 — re-raised at the wait
            self._error = e

    def _finalize(self) -> None:
        """Commit the finished background write (caller has waited)."""
        if self._pending is not None:
            tmp, final = self._pending
            self._pending = None
            _commit(tmp, final)
            _emit("checkpoint_save", path=final, deferred=True)

    def _abort_pending(self) -> None:
        """The awaited write FAILED: never commit its torn tmp over the
        last good checkpoint — drop the marker and the debris."""
        if self._pending is not None:
            tmp, _final = self._pending
            self._pending = None
            shutil.rmtree(tmp, ignore_errors=True)

    def _await_writer(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._abort_pending()
            raise err

    def save(self, path: str, state: TrainState) -> None:
        self.wait()  # at most one in flight
        path = os.path.abspath(path)
        tmp = _tmp_path(path)
        layout = _Layout(state.params)
        if layout.mesh is None:
            host = _host_copies(_leaves(state), self._buffers)
            self._buffers = host
            payload = _payload(state, host)
        else:
            host = _gather_state(state, layout)
            self._layout = layout
            if host is None:          # not the writer: nothing to write
                return
            payload = _payload(state, host, layout.names)
        if os.path.isdir(tmp):  # stale orphan, crashed writer
            shutil.rmtree(tmp)
        self._pending = (tmp, path)
        self._thread = threading.Thread(
            target=self._run, args=(tmp, payload),
            name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        err = None
        try:
            self._await_writer()
            self._finalize()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err = e
        if self._layout is not None:
            layout, self._layout = self._layout, None
            _settle(layout, err is None)
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait()
        self._buffers = None

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Restore into *target* (a freshly built state of the same structure,
    on any device): its tensors take the checkpoint's values in their own
    device and dtype, and *target* is returned. Raises
    ``CorruptCheckpointError`` when the checkpoint is missing, truncated,
    unreadable or does not match the target's structure — checked in full
    before any tensor of *target* is written."""
    from kubetpu_torch.obs import trace as obs_trace

    path = os.path.abspath(path)
    with obs_trace.span("checkpoint.restore", path=path):
        out = _restore_inner(path, target)
        _emit("checkpoint_restore", path=path)
    return out


def _load(path: str) -> dict:
    try:
        obj = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True, mmap=True)
    except Exception as e:  # noqa: BLE001 — torch / pickle / zip / OS
        # errors for truncation and mangling surface as ONE typed error
        raise CorruptCheckpointError(
            f"checkpoint at {path} is unreadable (truncated or mangled): "
            f"{type(e).__name__}: {e}") from e
    if not isinstance(obj, dict) or obj.get("format") != FORMAT:
        raise CorruptCheckpointError(
            f"checkpoint at {path} is not a {FORMAT} checkpoint")
    return obj


def _check(path: str, obj: dict, target: TrainState, layout: _Layout):
    """(source, target tensor, local spec) for every tensor of *target*
    (its rank's leaves, their moments, the count), after checking the
    whole model's names, counts and shapes against the checkpoint."""
    def bad(what: str):
        return CorruptCheckpointError(
            f"checkpoint at {path} does not match the target state: {what}")

    names = layout.names
    params = obj.get("params")
    if not isinstance(params, dict) or list(params) != names:
        raise bad("parameter names differ")
    n = len(names)
    mu, nu, count = obj.get("mu"), obj.get("nu"), obj.get("count")
    if (not isinstance(mu, list) or not isinstance(nu, list)
            or len(mu) != n or len(nu) != n
            or not torch.is_tensor(count) or count.dim() != 0
            or not isinstance(obj.get("step"), int)):
        raise bad("optimizer state or step malformed")
    opt = target.opt_state
    index = {id(p): j for j, p in enumerate(target.params.parameters())}
    pairs = [(count, opt.count, ())]
    for i, (name, shape, _dtype, spec, _stage, local) in enumerate(
            layout.leaves):
        for src in (params[name], mu[i], nu[i]):
            if not torch.is_tensor(src) or tuple(src.shape) != shape:
                raise bad(f"{name}: shape {getattr(src, 'shape', None)} "
                          f"!= {shape}")
        if local is not None:
            j = index[id(local)]
            pairs += [(params[name], local, spec), (mu[i], opt.mu[j], spec),
                      (nu[i], opt.nu[j], spec)]
    return pairs


def _restore_inner(path: str, target: TrainState) -> TrainState:
    if not os.path.isdir(path):
        if os.path.isdir(path + ".old"):
            # a writer died between _commit's two renames: the previous
            # generation survives set-aside — restore it rather than fail
            warnings.warn(
                f"checkpoint at {path} is missing but a set-aside "
                f"previous generation exists; restoring {path}.old",
                stacklevel=3,
            )
            path = path + ".old"
        else:
            raise CorruptCheckpointError(
                f"no checkpoint directory at {path} (crashed mid-save "
                f"leaves only a .tmp-* orphan; resume from an older step)"
            )
    obj = _load(path)
    layout = _Layout(target.params)
    pairs = _check(path, obj, target, layout)
    with torch.no_grad():
        for src, dst, spec in pairs:
            dst.copy_(src[train_lib._region(src.shape, spec, layout.mesh)])
    target.step = obj["step"]
    del obj, pairs                 # unmap the file
    return target


def latest_step_dir(root: str) -> Optional[str]:
    """Resume helper: the highest-numbered step directory under *root*
    (layout: root/<step>/...); ``.tmp-*`` orphans and ``.old`` set-asides
    are not step directories."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))
