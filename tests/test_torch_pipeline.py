"""The port's GPipe pipeline against the JAX package's, in one 8-rank gloo
world on the CPU, from the same weights (``convert.shard_params(...,
pp=True)`` of the JAX tree): the counterparts of the reference's
tests/test_jobs.py pipeline tests with ep = 1 — the pipelined forward on
{dp 2, pp 2, sp 2} against the plain forward and the JAX pipeline's; two
steps at lr STEP_LR with the materialized and the chunked loss tail
against the JAX pipeline step and each other; and on {dp 1, pp 2, sp 2,
tp 2} the flash ring inside the stages against the dense ring, both
against the JAX pipeline step. The steps are held to JAX's in their
losses and in each weight's change; the gradient each hands its
optimizer, and the clip's global norm, to ``jax.grad`` and
``optax.global_norm`` of the plain JAX loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.jobs.pipeline import (make_pipeline_forward,
                                   make_pipeline_train_step)

from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import spawn

KW = dict(vocab=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
          max_seq=64)
M1 = {"dp": 2, "pp": 2, "sp": 2, "tp": 1}
M2 = {"dp": 1, "pp": 2, "sp": 2, "tp": 2}
RTOL, ATOL = 2e-4, 2e-5          # the forward, as the reference's test
LOSS_RTOL = 1e-4                 # f32 sums in another order
GRAD_TOL = 1e-5                  # the summed gradient: of the leaf's
                                 # largest element; the norm: relative
STEPS = 2
# a weight's change over the steps against JAX's: as the sharded step's
# test (test_torch_sharded_train.MESH_UPDATE_TOL, where the bound is
# reasoned)
MESH_UPDATE_TOL = 1e-3


def _tokens(shape, seed):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         KW["vocab"]))


TOK1 = _tokens((8, 16), 1)
TOK2 = _tokens((4, 32), 2)


def _batch(tok):
    return tok, np.roll(tok, -1, axis=1)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), jmodel.ModelConfig(**KW)))


# (kind, config overrides, mesh, microbatches, ring impl, tokens)
CASES = {
    "forward": ("forward", {}, M1, 4, "dense", TOK1),
    "step": ("step", {}, M1, 4, "dense", TOK1),
    "step_chunked": ("step", {"loss_chunk": 8}, M1, 4, "dense", TOK1),
    "tp_dense_ring": ("step", {}, M2, 2, "dense", TOK2),
    "tp_flash_ring": ("step", {}, M2, 2, "flash", TOK2),
}
NAMES = list(CASES)


@pytest.fixture(scope="module")
def world(params, tmp_path_factory):
    cases = []
    for name in NAMES:
        kind, over, mesh, micro, impl, tok = CASES[name]
        case = dict(kind=kind, cfg=dict(KW, **over), mesh=mesh,
                    microbatches=micro, impl=impl, params=params)
        if kind == "forward":
            case["tokens"] = tok
        else:
            case["batches"] = [_batch(tok)] * STEPS
            case["opt"] = {"lr": STEP_LR}
        cases.append(case)
    res = spawn("pipeline", 8, tmp_path_factory.mktemp("pipeline"),
                {"cases": cases})
    assert all(r["foreign"] == [] for r in res)
    return res


def _jax_mesh(axes):
    return make_mesh(dict(axes, ep=1))


@pytest.fixture(scope="module")
def jax_steps(params):
    """name -> (losses, weights, gradients at each step's weights) of the
    JAX pipeline step, each case run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_step(params, name)
        return cache[name]

    return get


def _jcfg(name):
    return dataclasses.replace(jmodel.ModelConfig(**KW), **CASES[name][1])


def _jax_grad(name):
    """The gradient of the plain JAX loss (the pipeline's loss is the
    plain one)."""
    jcfg = _jcfg(name)
    return jax.jit(jax.grad(lambda p, t, y: jmodel.next_token_loss(
        p, t, y, jcfg)))


def _jax_step(params, name):
    _kind, _over, axes, micro, _impl, tok = CASES[name]
    cfg = _jcfg(name)
    mesh = _jax_mesh(axes)
    state, tx = jtrain.init_state(
        jax.random.PRNGKey(0), cfg, mesh, pp=True,
        optimizer=jtrain.make_optimizer(lr=STEP_LR))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = make_pipeline_train_step(cfg, mesh, micro, optimizer=tx)
    grad = _jax_grad(name)
    losses, grads = [], []
    batch = [jnp.asarray(x) for x in _batch(tok)]
    for _ in range(STEPS):
        grads.append(jax.tree.map(np.asarray, grad(state.params, *batch)))
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params), grads


def _rank_block(rank, full):
    """Rank *rank*'s block of a (B, S, ...) array on M1 under the forward
    case's 4 microbatches of 2 rows (ranks walk dp, pp, sp row-major; the
    block is, of every microbatch, its row on dp, and positions on sp:
    ``pipeline.pipeline_rows``)."""
    dp, sp = rank // 4, rank % 2
    cols = full.shape[1] // 2
    return full[dp::2, sp * cols:(sp + 1) * cols]


@pytest.mark.parametrize("rank", range(8))
def test_pipeline_forward_matches_reference(world, params, rank):
    """The pipelined forward's logits (each rank its block, every pp rank
    alike) against the plain JAX forward and the JAX pipeline's."""
    cfg = jmodel.ModelConfig(**KW)
    want = np.asarray(jmodel.forward(params, jnp.asarray(TOK1), cfg))
    got = world[rank]["cases"][NAMES.index("forward")]["logits"]
    np.testing.assert_allclose(got, _rank_block(rank, want), rtol=RTOL,
                               atol=ATOL)
    if rank == 0:
        jpipe = make_pipeline_forward(cfg, _jax_mesh(M1), 4, use_ring=True)
        np.testing.assert_allclose(
            np.asarray(jax.jit(jpipe)(params, jnp.asarray(TOK1))), want,
            rtol=RTOL, atol=ATOL)


STEP_NAMES = ["step", "step_chunked", "tp_dense_ring", "tp_flash_ring"]


@pytest.mark.parametrize("name", ["step", "step_chunked", "tp_dense_ring"])
def test_pipeline_step_matches_jax(world, params, jax_steps, name):
    """Both steps' losses and each weight's change over them against the
    JAX pipeline step's."""
    want_losses, want_params, jgrads = jax_steps(name)
    got = world[0]["cases"][NAMES.index(name)]
    for r in world:
        assert r["cases"][NAMES.index(name)]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert_updates_match(params, got["params"], params, want_params, jgrads,
                         MESH_UPDATE_TOL)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_pipeline_gradient_and_clip_norm_match_jax(world, params, name):
    """The gradient the pipelined step hands its optimizer (every stage's
    blocks' through the backward hops, the embedding's summed over pp)
    against ``jax.grad`` of the plain JAX loss, and ``GradSync.sq_norm``'s
    global norm against ``optax.global_norm`` of it, on every rank."""
    i = NAMES.index(name)
    want = _jax_grad(name)(jax.tree.map(jnp.asarray, params),
                           *(jnp.asarray(x) for x in _batch(CASES[name][5])))
    got = world[0]["cases"][i]["probe"]["grads"]

    def check(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, got, want)
    want_norm = float(optax.global_norm(want))
    for r in world:
        assert r["cases"][i]["probe"]["norm"] == pytest.approx(
            want_norm, rel=GRAD_TOL)


def test_pipeline_chunked_loss_matches_unchunked(world, params, jax_steps):
    """The head runs outside the stages, so cfg.loss_chunk drops in: the
    same losses and weight changes as the materialized tail."""
    a = world[0]["cases"][NAMES.index("step")]
    b = world[0]["cases"][NAMES.index("step_chunked")]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    _, _, jgrads = jax_steps("step")
    assert_updates_match(params, b["params"], params, a["params"], jgrads,
                         MESH_UPDATE_TOL)


def test_pipeline_flash_ring_matches_dense_ring(world, params, jax_steps):
    """The flash ring inside every stage (the kernels' plain versions on
    the CPU) gives the dense-ring pipeline's losses, and the JAX pipeline
    step's weight changes."""
    dense = world[0]["cases"][NAMES.index("tp_dense_ring")]
    flash = world[0]["cases"][NAMES.index("tp_flash_ring")]
    np.testing.assert_allclose(flash["losses"], dense["losses"],
                               rtol=LOSS_RTOL)
    _, want_params, jgrads = jax_steps("tp_dense_ring")
    assert_updates_match(params, flash["params"], params, want_params,
                         jgrads, MESH_UPDATE_TOL)
