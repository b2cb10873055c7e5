"""Sharded checkpoints in the port (``kubetpu_torch/jobs/checkpoint.py``),
the counterparts of tests/test_jobs_io.py's meshed round trip, its
restore onto another mesh layout and its pipeline round trip. Each world
steps a meshed state, saves it, and restores it into a fresh state of
another seed; what was saved and what came back are gathered whole and
held equal bit for bit (parameters, both moments, count, step):

- {dp 2, tp 2} onto the same mesh (a 4-rank world of its own): every rank
  must get its own tp slices back, not one rank's;
- {dp 1, sp 4, tp 2} onto {dp 2, sp 2, tp 2}, whose next step's loss
  equals a one-device restore's step within LOSS_RTOL (the one-device step
  dense, the meshed one the dense ring: f32 summation order only);
- a pipeline state over {dp 2, pp 2, tp 2} (global layer names);
- a MoE state over {dp 2, ep 2, tp 2} onto {dp 4, ep 2};
- a one-device checkpoint onto {dp 2, sp 2, tp 2}, and every meshed
  checkpoint onto one device;
- the async checkpointer on a mesh: the snapshot taken at ``save``, not
  the state after the in-place step that follows."""

import os

import numpy as np
import pytest
import torch

from kubetpu_torch.jobs import checkpoint as ckpt
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs.convert import params_to_numpy

from test_torch_sharded_train import LOSS_RTOL
from torch_mesh_worlds import spawn

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
MOE = dict(KW, n_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
MESH3 = {"dp": 2, "sp": 2, "tp": 2}


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, KW["vocab"], (4, 32))
        out.append((tok, np.roll(tok, -1, axis=1)))
    return out


def _one_device_state(cfg_kw, seed=9, steps=()):
    opt = ttrain.make_optimizer(lr=1e-2)
    cfg = tmodel.ModelConfig(**cfg_kw)
    state, opt = ttrain.init_state(torch.Generator().manual_seed(seed), cfg,
                                   opt, device="cpu")
    step = ttrain.make_train_step(cfg, opt, attention="dense", device="cpu")
    for batch in steps:
        state, _ = step(state, *batch)
    return state, step


def _tree_of(state):
    """A one-device state as ``torch_mesh_worlds._state_tree`` gathers a
    meshed one."""
    import copy

    out = {"params": params_to_numpy(state.params),
           "count": int(state.opt_state.count), "step": int(state.step)}
    for which in ("mu", "nu"):
        holder = copy.deepcopy(state.params)
        with torch.no_grad():
            for p, m in zip(holder.parameters(),
                            getattr(state.opt_state, which)):
                p.copy_(m)
        out[which] = params_to_numpy(holder)
    return out


def _assert_trees_equal(got, want, what):
    assert got["count"] == want["count"] and got["step"] == want["step"]
    for part in ("params", "mu", "nu"):
        for k in ("embed", "ln_f", "head"):
            assert np.array_equal(got[part][k], want[part][k]), (
                what, part, k)
        for k in want[part]["blocks"]:
            assert np.array_equal(got[part]["blocks"][k],
                                  want[part]["blocks"][k]), (what, part, k)


@pytest.fixture(scope="module")
def repair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_dp2tp2")
    res = spawn("checkpoint", 4, tmp, {"dir": str(tmp), "cases": [
        dict(name="dp2tp2", cfg=KW, mesh={"dp": 2, "tp": 2},
             batches=_batches(2, 1))]})
    assert all(r["foreign"] == [] for r in res)
    return res, tmp


def test_meshed_save_restores_each_rank_its_own_slices(repair):
    """A {dp 2, tp 2} state saved and restored on the same mesh: the
    gathered state equals the saved one bit for bit (each tp rank its own
    wq slice), and the file restores onto one device as the whole
    model."""
    res, tmp = repair
    for r in res:
        got = r["dp2tp2"]
        _assert_trees_equal(got["restored"], got["saved"], "dp2tp2")
    one, _ = _one_device_state(KW)
    ckpt.restore_checkpoint(os.path.join(tmp, "dp2tp2"), one)
    _assert_trees_equal(_tree_of(one), res[0]["dp2tp2"]["saved"],
                        "one device")


@pytest.fixture(scope="module")
def one_device_file(tmp_path_factory):
    """A one-device checkpoint after two dense steps, and its state."""
    tmp = tmp_path_factory.mktemp("ckpt_one")
    state, _ = _one_device_state(KW, seed=5, steps=_batches(2, 2))
    path = str(tmp / "one")
    ckpt.save_checkpoint(path, state)
    return path, _tree_of(state)


CASES = {
    "cross": dict(cfg=KW, mesh={"dp": 1, "sp": 4, "tp": 2},
                  target_mesh=MESH3, batches=_batches(2, 3),
                  next_batch=_batches(1, 4)[0]),
    "pp": dict(cfg=KW, mesh={"dp": 2, "pp": 2, "tp": 2}, pp=True,
               batches=_batches(1, 5)),
    "ep": dict(cfg=MOE, mesh={"dp": 2, "ep": 2, "tp": 2},
               target_mesh={"dp": 4, "ep": 2}, batches=_batches(1, 6)),
    "async": dict(cfg=KW, mesh=MESH3, batches=_batches(1, 7),
                  **{"async": True}),
}


@pytest.fixture(scope="module")
def world(one_device_file, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_world")
    cases = [dict(c, name=n) for n, c in CASES.items()]
    cases.append(dict(name="from_one", cfg=KW, target_mesh=MESH3,
                      restore_from=one_device_file[0]))
    res = spawn("checkpoint", 8, tmp, {"dir": str(tmp), "cases": cases})
    assert all(r["foreign"] == [] for r in res)
    return res, tmp


@pytest.mark.parametrize("name", ["cross", "pp", "ep", "async"])
def test_meshed_state_restores_bit_exactly_onto_any_layout(world, name):
    """What was saved equals what came back on the target layout, bit for
    bit, on every rank (for ``async``: the snapshot at ``save``, though
    the state stepped on in place before the write)."""
    res, _tmp = world
    for r in res:
        _assert_trees_equal(r[name]["restored"], r[name]["saved"], name)
    assert res[0][name]["saved"]["step"] == len(CASES[name]["batches"])


@pytest.mark.parametrize("name", ["cross", "pp", "ep", "async"])
def test_meshed_checkpoint_restores_onto_one_device(world, name):
    """Each meshed checkpoint (whole model's names, a pipeline's global
    layers) restores onto one device as the whole saved state."""
    res, tmp = world
    one, _ = _one_device_state(CASES[name]["cfg"])
    ckpt.restore_checkpoint(os.path.join(tmp, name), one)
    _assert_trees_equal(_tree_of(one), res[0][name]["saved"], name)


def test_one_device_checkpoint_restores_onto_a_mesh(world, one_device_file):
    res, _tmp = world
    for r in res:
        _assert_trees_equal(r["from_one"]["restored"], one_device_file[1],
                            "from_one")


def test_cross_layout_next_step_equals_a_one_device_restore(world):
    """The step after the {dp 1, sp 4, tp 2} -> {dp 2, sp 2, tp 2} restore
    gives the loss of the same step after a one-device restore of the
    same file, on every rank."""
    res, tmp = world
    one, step = _one_device_state(KW)
    ckpt.restore_checkpoint(os.path.join(tmp, "cross"), one)
    _, loss = step(one, *CASES["cross"]["next_batch"])
    for r in res:
        assert r["cross"]["next_loss"] == pytest.approx(float(loss),
                                                        rel=LOSS_RTOL)


def test_a_meshed_restore_checks_the_whole_shapes(world):
    """A meshed checkpoint of one config does not restore into a state of
    another (the whole model's shapes are compared, not a rank's)."""
    _res, tmp = world
    one, _ = _one_device_state(dict(KW, d_ff=128))
    before = [t.clone() for t in ckpt._leaves(one)]
    with pytest.raises(ckpt.CorruptCheckpointError, match="does not match"):
        ckpt.restore_checkpoint(os.path.join(tmp, "cross"), one)
    for a, b in zip(before, ckpt._leaves(one)):
        assert torch.equal(a, b)
