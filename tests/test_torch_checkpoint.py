"""Checkpoint and resume in the port (``kubetpu_torch/jobs/checkpoint.py``):
exact round trips of the whole train state, the crash-safety protocol
(temp sibling, commit, ``.old`` set-aside), typed errors for missing,
truncated, mangled or mismatched checkpoints, the async writer's snapshot
isolation and commit points, and resume: N steps, save, restore, M steps
equals N + M uninterrupted steps exactly on the CPU, and the restored run's
losses equal the JAX package's restored run (its orbax checkpoint) within
1e-4 relative, from the same weights and batches (f32, dense attention on
both sides: summation order only)."""

import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs import checkpoint as jckpt
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh
from kubetpu_torch.jobs import checkpoint as ckpt
from kubetpu_torch.jobs import data as tdata
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import params_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=64, max_seq=64)
JCFG = jmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=64, max_seq=64)


def _batches(n, seed=5):
    it = tdata.SyntheticCorpus(CFG.vocab, seed=3).batches(4, 32, seed=seed)
    return [next(it) for _ in range(n)]


def _state(seed=0, cfg=CFG):
    state, opt = ttrain.init_state(torch.Generator().manual_seed(seed), cfg,
                                   device="cpu")
    return state, opt


def _trained(n_steps=2, seed=0):
    state, opt = _state(seed)
    step = ttrain.make_train_step(CFG, opt, attention="dense", device="cpu")
    for tokens, targets in _batches(n_steps):
        state, _ = step(state, tokens, targets)
    return state, opt, step


def _leaves(state):
    return ckpt._leaves(state)


def _assert_state_equal(a, b):
    assert a.step == b.step
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach().cpu(), y.detach().cpu())


def test_round_trip_is_exact(tmp_path):
    state, _opt, _step = _trained()
    path = tmp_path / "run" / "2"
    ckpt.save_checkpoint(str(path), state)
    assert os.listdir(tmp_path / "run") == ["2"]
    fresh, _ = _state(seed=42)
    restored = ckpt.restore_checkpoint(str(path), fresh)
    assert restored is fresh
    _assert_state_equal(restored, state)
    assert int(restored.opt_state.count) == 2


def test_restore_casts_into_the_target_dtype(tmp_path):
    """The target's dtype wins: an f32 checkpoint restores into a bf16
    state as the cast values."""
    import dataclasses

    state, _opt, _step = _trained()
    ckpt.save_checkpoint(str(tmp_path / "c"), state)
    bf = dataclasses.replace(CFG, dtype=torch.bfloat16)
    target, _ = _state(seed=3, cfg=bf)
    ckpt.restore_checkpoint(str(tmp_path / "c"), target)
    for src, dst in zip(_leaves(state), _leaves(target)):
        assert dst.dtype == (torch.int32 if src.dim() == 0 else torch.bfloat16)
        assert torch.equal(dst, src.detach().to(dst.dtype))


def test_overwrite_sets_the_old_generation_aside(tmp_path):
    state, _opt, step = _trained()
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, state)
    tokens, targets = _batches(1, seed=9)[0]
    state, _ = step(state, tokens, targets)
    ckpt.save_checkpoint(path, state)           # overwrite: commit + .old
    assert sorted(os.listdir(tmp_path)) == ["c"]
    fresh, _ = _state(seed=1)
    _assert_state_equal(ckpt.restore_checkpoint(path, fresh), state)


def test_old_generation_restores_with_a_warning(tmp_path):
    """A writer killed between the commit's two renames leaves only
    ``<path>.old``: restore takes it and warns."""
    state, _opt, _step = _trained()
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, state)
    os.replace(path, path + ".old")
    fresh, _ = _state(seed=1)
    with pytest.warns(UserWarning, match=r"\.old"):
        restored = ckpt.restore_checkpoint(path, fresh)
    _assert_state_equal(restored, state)


CRASH = """
import os, sys, torch
sys.path.insert(0, {repo!r})
from kubetpu_torch.jobs import checkpoint as ckpt, train
from kubetpu_torch.jobs.model import ModelConfig
cfg = ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64)
state, _ = train.init_state(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
def dying_save(obj, f):
    f.write(b"PK-half-written")
    f.flush()
    os._exit(3)                   # killed mid-write: no cleanup runs
torch.save = dying_save
ckpt.save_checkpoint({path!r}, state)
"""


def test_crash_mid_save_leaves_only_an_ignored_orphan(tmp_path):
    root = tmp_path / "run"
    state, _opt, _step = _trained()
    ckpt.save_checkpoint(str(root / "1"), state)
    proc = subprocess.run(
        [sys.executable, "-c", CRASH.format(repo=REPO, path=str(root / "2"))],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3, proc.stderr
    names = sorted(os.listdir(root))
    assert names[0] == "1" and len(names) == 2
    assert names[1].startswith("2.tmp-")
    assert ckpt.latest_step_dir(str(root)) == str(root / "1")
    assert jckpt.latest_step_dir(str(root)) == str(root / "1")
    fresh, _ = _state(seed=1)
    with pytest.raises(ckpt.CorruptCheckpointError, match="no checkpoint"):
        ckpt.restore_checkpoint(str(root / "2"), fresh)
    _assert_state_equal(ckpt.restore_checkpoint(str(root / "1"), fresh),
                        state)
    # a later save by a process of the same pid replaces a stale orphan
    stale = f"{root / '3'}.tmp-{os.getpid()}"
    os.makedirs(stale)
    ckpt.save_checkpoint(str(root / "3"), state)
    assert not os.path.exists(stale)


def test_failed_save_leaves_no_debris(tmp_path, monkeypatch):
    state, _opt, _step = _trained()

    def broken(directory, payload):
        os.makedirs(directory)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(str(tmp_path / "c"), state)
    assert os.listdir(tmp_path) == []


def _corrupt_cases(tmp_path, state):
    """(name, path) of checkpoints that must not load."""
    good = tmp_path / "good"
    ckpt.save_checkpoint(str(good), state)
    blob = (good / ckpt.STATE_FILE).read_bytes()
    out = [("missing", tmp_path / "404")]
    for name, data in (("truncated", blob[:len(blob) // 2]),
                       ("garbage", b"\x00not a checkpoint" * 10),
                       ("empty", b"")):
        d = tmp_path / name
        d.mkdir()
        (d / ckpt.STATE_FILE).write_bytes(data)
        out.append((name, d))
    no_file = tmp_path / "no_file"
    no_file.mkdir()
    out.append(("no_file", no_file))
    for name, obj in (("other_format", {"format": "x"}),
                      ("not_a_dict", [1, 2, 3])):
        d = tmp_path / name
        d.mkdir()
        torch.save(obj, str(d / ckpt.STATE_FILE))
        out.append((name, d))
    # a pickle that weights_only refuses to run
    d = tmp_path / "code"
    d.mkdir()
    torch.save({"format": ckpt.FORMAT, "f": threading.Lock},
               str(d / ckpt.STATE_FILE))
    out.append(("code", d))
    return out


def test_corrupt_checkpoints_raise_the_typed_error(tmp_path):
    state, _opt, _step = _trained()
    fresh, _ = _state(seed=1)
    before = [t.clone() for t in _leaves(fresh)]
    for name, path in _corrupt_cases(tmp_path, state):
        with pytest.raises(ckpt.CorruptCheckpointError):
            ckpt.restore_checkpoint(str(path), fresh)
    assert isinstance(ckpt.CorruptCheckpointError("x"), ckpt.CheckpointError)
    for a, b in zip(before, _leaves(fresh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change", ["layers", "width", "kv_heads", "step",
                                    "moments"])
def test_mismatched_structure_is_typed_and_writes_nothing(tmp_path, change):
    import dataclasses

    state, _opt, _step = _trained()
    path = tmp_path / "c"
    ckpt.save_checkpoint(str(path), state)
    if change in ("step", "moments"):
        obj = torch.load(str(path / ckpt.STATE_FILE), weights_only=True)
        if change == "step":
            obj["step"] = "two"
        else:
            obj["mu"] = obj["mu"][:-1]
        torch.save(obj, str(path / ckpt.STATE_FILE))
        cfg = CFG
    else:
        cfg = dataclasses.replace(CFG, **{
            "layers": dict(n_layers=3), "width": dict(d_model=64),
            "kv_heads": dict(n_kv_heads=4)}[change])
    target, _ = _state(seed=1, cfg=cfg)
    before = [t.clone() for t in _leaves(target)]
    with pytest.raises(ckpt.CorruptCheckpointError, match="does not match"):
        ckpt.restore_checkpoint(str(path), target)
    for a, b in zip(before, _leaves(target)):
        assert torch.equal(a, b)


def test_async_save_is_isolated_from_later_in_place_updates(tmp_path,
                                                            monkeypatch):
    """The writer thread runs only after three more in-place train steps
    (it is held on an event); the committed checkpoint still holds the
    state as it was when ``save`` returned."""
    state, _opt, step = _trained()
    snapshot = [t.detach().clone() for t in _leaves(state)]
    saved_step = state.step
    go = threading.Event()
    real = ckpt._write

    def held(directory, payload):
        assert go.wait(60)
        real(directory, payload)

    monkeypatch.setattr(ckpt, "_write", held)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "c"), state)
    for tokens, targets in _batches(3, seed=11):
        state, _ = step(state, tokens, targets)
    assert not torch.equal(_leaves(state)[0], snapshot[0])
    go.set()
    saver.wait()
    fresh, _ = _state(seed=1)
    ckpt.restore_checkpoint(str(tmp_path / "c"), fresh)
    assert fresh.step == saved_step
    for a, b in zip(snapshot, _leaves(fresh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("how", ["wait", "close", "context", "next_save"])
def test_async_commit_points(tmp_path, how):
    """The write lands in a ``.tmp-*`` sibling and is renamed into place
    at the next save / wait / close, never before."""
    state, _opt, step = _trained()
    root = tmp_path / "run"
    saver = ckpt.AsyncCheckpointer()
    if how == "context":
        with ckpt.AsyncCheckpointer() as ctx:
            ctx.save(str(root / "2"), state)
            assert not (root / "2").exists()
        assert os.listdir(root) == ["2"]
        return
    saver.save(str(root / "2"), state)
    assert not (root / "2").exists()
    assert ckpt.latest_step_dir(str(root)) is None
    if how == "wait":
        saver.wait()
    elif how == "close":
        saver.close()
    else:
        tokens, targets = _batches(1, seed=9)[0]
        state, _ = step(state, tokens, targets)
        saver.save(str(root / "3"), state)
        assert (root / "2").exists()
        saver.close()
        assert sorted(os.listdir(root)) == ["2", "3"]
    assert (root / "2").exists()
    assert ckpt.latest_step_dir(str(root)) == str(
        root / ("3" if how == "next_save" else "2"))
    assert not [n for n in os.listdir(root) if ".tmp-" in n]


def test_async_write_failure_keeps_the_last_good_checkpoint(tmp_path,
                                                            monkeypatch):
    state, _opt, _step = _trained()
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, state)

    def broken(directory, payload):
        os.makedirs(directory, exist_ok=True)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    saver = ckpt.AsyncCheckpointer()
    saver.save(path, state)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    assert os.listdir(tmp_path) == ["c"]
    saver.wait()                                    # the error is consumed
    fresh, _ = _state(seed=1)
    _assert_state_equal(ckpt.restore_checkpoint(path, fresh), state)


def test_save_and_restore_are_spanned_and_logged(tmp_path):
    from kubetpu_torch.obs import trace as obs_trace
    from kubetpu_torch.obs.events import event_log

    state, _opt, _step = _trained()
    path = str(tmp_path / "c")
    ckpt.save_checkpoint(path, state)
    with ckpt.AsyncCheckpointer() as saver:
        saver.save(path, state)
    fresh, _ = _state(seed=1)
    ckpt.restore_checkpoint(path, fresh)
    ops = [s["op"] for s in obs_trace.tracer().spans()]
    assert "checkpoint.save" in ops and "checkpoint.restore" in ops
    kinds = [(e["kind"], e.get("deferred")) for e in event_log().events()
             if e.get("path") == os.path.abspath(path)]
    assert kinds == [("checkpoint_save", None), ("checkpoint_save", True),
                     ("checkpoint_restore", None)]


@pytest.mark.parametrize("n,m", [(2, 3), (1, 1)])
def test_resume_equals_uninterrupted_training(tmp_path, n, m):
    """N steps, save, restore into a fresh state, M steps == N + M steps
    without the interruption: every loss and every leaf exactly."""
    batches = _batches(n + m)
    state, opt = _state(seed=0)
    step = ttrain.make_train_step(CFG, opt, attention="flash", device="cpu")
    straight = []
    for tokens, targets in batches:
        state, loss = step(state, tokens, targets)
        straight.append(float(loss))

    first, opt2 = _state(seed=0)
    step2 = ttrain.make_train_step(CFG, opt2, attention="flash",
                                   device="cpu")
    resumed = []
    for tokens, targets in batches[:n]:
        first, loss = step2(first, tokens, targets)
        resumed.append(float(loss))
    ckpt.save_checkpoint(str(tmp_path / str(n)), first)
    del first
    fresh, opt3 = _state(seed=99)
    fresh = ckpt.restore_checkpoint(
        ckpt.latest_step_dir(str(tmp_path)), fresh)
    step3 = ttrain.make_train_step(CFG, opt3, attention="flash",
                                   device="cpu")
    for tokens, targets in batches[n:]:
        fresh, loss = step3(fresh, tokens, targets)
        resumed.append(float(loss))
    assert resumed == straight
    _assert_state_equal(fresh, state)


def test_resumed_losses_equal_the_jax_resumed_run(tmp_path):
    """The same weights and batches through both packages: 2 steps, a
    checkpoint (orbax on the JAX side, the port's file on this side), a
    restore into a fresh state, 2 more steps. Every loss within 1e-4
    relative (f32, dense attention: summation order only)."""
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jstate, jopt = jtrain.init_state(jax.random.PRNGKey(0), JCFG, mesh)
    model = params_from_numpy(jax.tree.map(np.asarray, jstate.params), CFG,
                              device="cpu")
    jstep = jtrain.make_train_step(JCFG, mesh, optimizer=jopt,
                                   attention="dense")
    opt = ttrain.make_optimizer()
    state = ttrain.state_from_params(model, opt)
    tstep = ttrain.make_train_step(CFG, opt, attention="dense", device="cpu")
    batches = _batches(4, seed=7)
    jl, tl = [], []
    for tokens, targets in batches[:2]:
        jstate, loss = jstep(jstate, tokens, targets)
        jl.append(float(loss))
        state, loss = tstep(state, tokens, targets)
        tl.append(float(loss))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate)
    ckpt.save_checkpoint(str(tmp_path / "port"), state)
    jfresh, _ = jtrain.init_state(jax.random.PRNGKey(5), JCFG, mesh)
    jstate = jckpt.restore_checkpoint(str(tmp_path / "jax"), jfresh)
    fresh, _ = _state(seed=5)
    state = ckpt.restore_checkpoint(str(tmp_path / "port"), fresh)
    assert int(jstate.step) == state.step == 2
    for tokens, targets in batches[2:]:
        jstate, loss = jstep(jstate, tokens, targets)
        jl.append(float(loss))
        state, loss = tstep(state, tokens, targets)
        tl.append(float(loss))
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl, jl)
