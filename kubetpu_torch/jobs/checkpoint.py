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
from typing import List, Optional

import torch

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


def _payload(state: TrainState, host: List[torch.Tensor]) -> dict:
    """The object ``torch.save`` writes, over host copies *host* of
    ``_leaves(state)``."""
    names = [n for n, _p in state.params.named_parameters()]
    n = len(names)
    return {"format": FORMAT, "step": int(state.step),
            "params": dict(zip(names, host[:n])), "count": host[n],
            "mu": host[n + 1:2 * n + 1], "nu": host[2 * n + 1:]}


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


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write a TrainState to *path* (created if needed): temp-write +
    atomic rename, so a crash mid-save never leaves a torn checkpoint at
    the real path. Spanned (``checkpoint.save``)."""
    from kubetpu_torch.obs import trace as obs_trace

    path = os.path.abspath(path)
    with obs_trace.span("checkpoint.save", path=path):
        tmp = _tmp_path(path)
        if os.path.isdir(tmp):  # stale orphan from a crashed writer: replace
            shutil.rmtree(tmp)
        try:
            _write(tmp, _payload(state, _host_copies(_leaves(state))))
            _commit(tmp, path)
            _emit("checkpoint_save", path=path)
        finally:
            if os.path.isdir(tmp):  # failed before commit: no orphan leak
                shutil.rmtree(tmp, ignore_errors=True)


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
        self._await_writer()  # at most one in flight
        self._finalize()
        path = os.path.abspath(path)
        tmp = _tmp_path(path)
        if os.path.isdir(tmp):  # stale orphan, crashed writer
            shutil.rmtree(tmp)
        host = _host_copies(_leaves(state), self._buffers)
        self._buffers = host
        self._pending = (tmp, path)
        self._thread = threading.Thread(
            target=self._run, args=(tmp, _payload(state, host)),
            name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        self._await_writer()
        self._finalize()

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
                         weights_only=True)
    except Exception as e:  # noqa: BLE001 — torch / pickle / zip / OS
        # errors for truncation and mangling surface as ONE typed error
        raise CorruptCheckpointError(
            f"checkpoint at {path} is unreadable (truncated or mangled): "
            f"{type(e).__name__}: {e}") from e
    if not isinstance(obj, dict) or obj.get("format") != FORMAT:
        raise CorruptCheckpointError(
            f"checkpoint at {path} is not a {FORMAT} checkpoint")
    return obj


def _check(path: str, obj: dict, target: TrainState) -> List[torch.Tensor]:
    """The checkpoint's tensors in ``_leaves(target)``'s order, after
    checking names, counts and shapes against *target*."""
    def bad(what: str):
        return CorruptCheckpointError(
            f"checkpoint at {path} does not match the target state: {what}")

    named = list(target.params.named_parameters())
    params = obj.get("params")
    if not isinstance(params, dict) or list(params) != [n for n, _ in named]:
        raise bad("parameter names differ")
    n = len(named)
    mu, nu, count = obj.get("mu"), obj.get("nu"), obj.get("count")
    if (not isinstance(mu, list) or not isinstance(nu, list)
            or len(mu) != n or len(nu) != n
            or not torch.is_tensor(count) or count.dim() != 0
            or not isinstance(obj.get("step"), int)):
        raise bad("optimizer state or step malformed")
    loaded = list(params.values()) + [count] + mu + nu
    for i, (src, dst) in enumerate(zip(loaded, _leaves(target))):
        if not torch.is_tensor(src) or src.shape != dst.shape:
            raise bad(f"leaf {i}: shape "
                      f"{getattr(src, 'shape', None)} != {tuple(dst.shape)}")
    return loaded


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
    loaded = _check(path, obj, target)
    with torch.no_grad():
        for src, dst in zip(loaded, _leaves(target)):
            dst.copy_(src)
    target.step = obj["step"]
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
