"""The port's sharded LoRA step against the JAX package's, in one 8-rank
gloo world on the CPU: ``lora_param_specs`` equals the reference's specs
(tests/test_lora.py's sharding pins), and ``make_lora_train_step(...,
mesh=)`` on {dp 2, sp 2, tp 2} with the flash ring (the kernels' plain
versions on the CPU) against the JAX package's ``make_lora_train_step`` on
its 8-device mesh (tests/test_lora.py's config, every target adapted, the
B factors drawn off zero so that every factor has a gradient), from the
same base and adapter, two steps at lr STEP_LR: losses within 1e-4
relative on every rank, each factor's change by ``assert_updates_match``,
and the gradient ``lora_grad_sync`` hands the optimizer (tp-replicated
factors summed over tp, tp-sharded ones gathered) with its global norm
within 1e-5 of ``jax.grad`` and ``optax.global_norm``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubetpu.jobs import lora as jlora
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh
from kubetpu_torch.jobs import lora as tlora
from kubetpu_torch.jobs.model import ModelConfig

from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import spawn

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=64)
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MESH = {"dp": 2, "sp": 2, "tp": 2}
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
MESH_UPDATE_TOL = 1e-3     # test_torch_sharded_train's, reasoned there
JCFG = jmodel.ModelConfig(**KW)
JLCFG = jlora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS)


def _batches(n):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        tok = rng.integers(0, KW["vocab"], (4, 32))
        out.append((tok, np.roll(tok, -1, axis=1)))
    return out


@pytest.fixture(scope="module")
def trees():
    base = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), JCFG))
    lora = jlora.init_lora_params(jax.random.PRNGKey(1), JCFG, JLCFG)
    keys = jax.random.split(jax.random.PRNGKey(2), len(TARGETS))
    for k, t in zip(keys, TARGETS):
        b = lora["blocks"][f"{t}_b"]
        lora["blocks"][f"{t}_b"] = jax.random.normal(k, b.shape) * 0.05
    return base, jax.tree.map(np.asarray, lora)


@pytest.fixture(scope="module")
def world(trees, tmp_path_factory):
    base, lora = trees
    res = spawn("lora_train", 8, tmp_path_factory.mktemp("lora"),
                {"cfg": KW, "lcfg": {"rank": 4, "alpha": 8.0,
                                     "targets": TARGETS},
                 "mesh": MESH, "params": base, "lora": lora,
                 "attention": "ring_flash", "opt": {"lr": STEP_LR},
                 "batches": _batches(2)})
    assert all(r["foreign"] == [] for r in res)
    return res


def _jax_loss(lora, base, tokens, targets):
    return jmodel.next_token_loss(jlora.merge_lora(base, lora, JLCFG),
                                  tokens, targets, JCFG)


@pytest.fixture(scope="module")
def jax_run(trees):
    """The JAX sharded LoRA step's two losses, the adapter after them and
    the gradient at each step's adapter."""
    base, lora = trees
    mesh = make_mesh(MESH)
    state, tx = jlora.init_lora_state(
        jax.random.PRNGKey(1), JCFG, JLCFG, mesh,
        optimizer=jtrain.make_optimizer(lr=STEP_LR))
    state = state._replace(params=jax.tree.map(jnp.asarray, lora))
    step = jlora.make_lora_train_step(JCFG, JLCFG, mesh, optimizer=tx)
    grad = jax.jit(jax.grad(_jax_loss))
    jbase = jax.tree.map(jnp.asarray, base)
    losses, grads = [], []
    for batch in _batches(2):
        batch = [jnp.asarray(x) for x in batch]
        grads.append(jax.tree.map(np.asarray,
                                  grad(state.params, jbase, *batch)))
        state, loss = step(state, jbase, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params), grads


def test_lora_param_specs_equal_the_reference():
    """Every target's factor specs: the factor carrying a tp-sharded base
    axis keeps it on tp, the rank axis replicated."""
    cfg = ModelConfig(**KW)
    lcfg = tlora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS)
    want = jlora.lora_param_specs(JCFG, JLCFG)["blocks"]
    got = tlora.lora_param_specs(cfg, lcfg)["blocks"]
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k] == tuple(spec), k


def test_sharded_lora_step_matches_jax(world, trees, jax_run):
    """Both steps' losses on every rank, and each factor's change over them
    (gathered over tp), against the JAX package's sharded LoRA step."""
    _base, lora = trees
    want_losses, want_lora, jgrads = jax_run
    got = world[0]
    for r in world:
        assert r["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert_updates_match(lora, got["lora"], lora, want_lora, jgrads,
                         MESH_UPDATE_TOL)


def test_sharded_lora_gradient_and_norm_match_jax(world, jax_run):
    """The gradient the sharded LoRA step hands its optimizer against
    ``jax.grad`` of the merged loss, and its global norm against
    ``optax.global_norm``, on every rank."""
    _losses, _lora, jgrads = jax_run

    def check(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, world[0]["probe"]["grads"],
                                     jgrads[0])
    want = float(optax.global_norm(jgrads[0]))
    for r in world:
        assert r["probe"]["norm"] == pytest.approx(want, rel=GRAD_TOL)


def test_sharded_lora_refuses_accumulation():
    """``accum_steps > 1`` raises, as the reference's does."""
    cfg = ModelConfig(**KW)
    with pytest.raises(NotImplementedError, match="accum_steps"):
        tlora.make_lora_train_step(cfg, tlora.LoraConfig(), accum_steps=2,
                                   device="cpu", mesh=object())


def test_shard_lora_cuts_the_tp_factor():
    """``shard_lora`` cuts each factor by its spec: the tp-carrying factor
    to the rank's slice, the other whole (a stacked tree on its second
    axis)."""
    cfg = dataclasses.replace(ModelConfig(**KW))
    lcfg = tlora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS)
    import torch

    tree = tlora.init_lora_params(torch.Generator().manual_seed(0), cfg,
                                  lcfg, device="cpu")
    mesh = _TpMesh(2, 1)
    part = tlora.shard_lora(tree, mesh)["blocks"]
    assert torch.equal(part["wq_b"], tree["blocks"]["wq_b"][:, :, 2:])
    assert torch.equal(part["wo_a"], tree["blocks"]["wo_a"][:, 2:])
    assert torch.equal(part["w_down_a"], tree["blocks"]["w_down_a"][:, 32:])
    assert torch.equal(part["wq_a"], tree["blocks"]["wq_a"])
    stacked = {"blocks": {k: torch.stack([v, v]) for k, v in
                          tree["blocks"].items()}}
    part = tlora.shard_lora(stacked, mesh, stacked=True)["blocks"]
    assert torch.equal(part["wo_a"][1], tree["blocks"]["wo_a"][:, 2:])


class _TpMesh:
    """The DeviceMesh surface ``_take`` reads: one tp axis, this rank's
    index on it."""

    def __init__(self, size, index):
        self.mesh_dim_names = ("tp",)
        self._size, self._index = size, index

    def size(self, dim):
        return self._size

    def get_local_rank(self, name):
        return self._index
