"""The port's expert axis ``ep`` against the JAX package, in one 8-rank gloo
world on the CPU, from the same weights (``convert.shard_params`` of the
JAX tree) and batches, two steps at lr STEP_LR:

- the sharded step on {dp 2, ep 4} with capacity dispatch
  (tests/test_jobs.py's ``test_moe_capacity_trains_on_ep_mesh`` config),
  with the dense top-1 dispatch and the load-balance term
  (``test_moe_aux_loss_balances_router``'s), and top-2 capacity dispatch
  on {dp 2, tp 2, ep 2}, each against the JAX package's ``make_train_step``
  on its mesh: the capacity dispatch and the aux term span the global
  batch, and the experts' partial combine is summed over tp x ep;
- the five-axis pipeline {dp 1, pp 2, sp 2, tp 1, ep 2}
  (``test_pipeline_train_step_five_axes``' config, one step) against the
  JAX package's one-device step (its five-axis pipeline is ``slow`` in its
  own suite; top-1 dense dispatch routes each token alone, so the plain
  step is the same function), and ``_dryrun_pipeline``'s {dp 2, pp 2, ep
  2, sp 1} with capacity dispatch against the JAX one-device step with
  ``accum_steps`` = the microbatches (a capacity dispatch spans one
  microbatch there as in the pipeline);
- ``prefetch_to_mesh``: each rank's blocks equal ``local_batch``'s, in
  order, for (tokens, targets) and ``pack_documents``' triples
  (tests/test_jobs_io.py's prefetch cases), and the ep step fed by it
  gives the losses of the step fed the global batches.

Losses within 1e-4 relative, every weight's change by
``assert_updates_match``, the gradient each step hands its optimizer and
``GradSync``'s global norm within 1e-5 of ``jax.grad`` and
``optax.global_norm``, as in tests/test_torch_sharded_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.data import SyntheticCorpus, pack_documents
from kubetpu.jobs.meshjob import make_mesh

from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import spawn

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=64)
PIPE_KW = dict(KW, n_layers=4)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
MESH_UPDATE_TOL = 1e-3     # test_torch_sharded_train's, reasoned there

# name: (config overrides, mesh, batch shape)
STEPS = {
    "capacity": ({"n_experts": 4, "moe_capacity_factor": 1.5},
                 {"dp": 2, "ep": 4}, (4, 32)),
    "dense_aux": ({"n_experts": 4, "moe_aux_coeff": 0.01},
                  {"dp": 2, "ep": 4}, (2, 32)),
    "top2_tp_ep": ({"n_experts": 4, "moe_capacity_factor": 1.5,
                    "moe_top_k": 2, "moe_aux_coeff": 0.01},
                   {"dp": 2, "tp": 2, "ep": 2}, (4, 32)),
}
STEP_NAMES = list(STEPS)
# name: (config overrides, mesh, microbatches, batch shape, steps)
PIPES = {
    "five_axis": ({"n_experts": 2},
                  {"dp": 1, "pp": 2, "sp": 2, "tp": 1, "ep": 2}, 2, (4, 16),
                  1),
    "dryrun_capacity": ({"n_experts": 4, "moe_capacity_factor": 2.0},
                        {"dp": 2, "pp": 2, "sp": 1, "ep": 2}, 2, (4, 32),
                        2),
}
PIPE_NAMES = list(PIPES)


def _batches(shape, n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, KW["vocab"], shape)
        out.append((tok, np.roll(tok, -1, axis=1)))
    return out


def _jcfg(kw, over):
    return dataclasses.replace(jmodel.ModelConfig(**kw), **over)


def _params(kw, over):
    return jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), _jcfg(kw, over)))


def _docs(n, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, KW["vocab"], lengths[i % len(lengths)])
            for i in range(n)]


@pytest.fixture(scope="module")
def trees():
    return {**{n: _params(KW, STEPS[n][0]) for n in STEP_NAMES},
            **{n: _params(PIPE_KW, PIPES[n][0]) for n in PIPE_NAMES}}


PREFETCH = [
    ({"dp": 2, "sp": 2, "tp": 2},
     [b for _, b in zip(range(4), SyntheticCorpus(vocab=64).batches(4, 32))]),
    ({"dp": 2, "ep": 4},
     list(pack_documents(iter(_docs(60, [7, 13])), batch=4, seq=16,
                         eos_id=0, mode="greedy"))),
]


@pytest.fixture(scope="module")
def world(trees, tmp_path_factory):
    train = [dict(cfg=dict(KW, **STEPS[n][0]), mesh=STEPS[n][1],
                  attention="dense", params=trees[n],
                  opt={"lr": STEP_LR}, probe=True,
                  batches=_batches(STEPS[n][2], 2)) for n in STEP_NAMES]
    pipes = []
    for n in PIPE_NAMES:
        over, mesh, micro, shape, steps = PIPES[n]
        pipes.append(dict(kind="step", cfg=dict(PIPE_KW, **over), mesh=mesh,
                          microbatches=micro, impl="dense", params=trees[n],
                          opt={"lr": STEP_LR},
                          batches=_batches(shape, steps)))
    payload = {"train": train, "pipeline": pipes,
               "prefetch": [dict(mesh=m, batches=b) for m, b in PREFETCH],
               "prefetched_step": dict(train[0])}
    res = spawn("moe_ep", 8, tmp_path_factory.mktemp("moe_ep"), payload,
                timeout=400)
    assert all(r["foreign"] == [] for r in res)
    return res


def _jax_grad(cfg, accum=1):
    """The gradient a JAX step hands its optimizer: ``jax.grad`` of the
    JAX loss, the micro-batches' mean under *accum*."""
    grad = jax.jit(jax.grad(lambda p, t, y: jmodel.next_token_loss(
        p, t, y, cfg)))

    def run(params, tokens, targets):
        micro = tokens.shape[0] // accum
        parts = [grad(params, tokens[i * micro:(i + 1) * micro],
                      targets[i * micro:(i + 1) * micro])
                 for i in range(accum)]
        return jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0), *parts)

    return run


def _jax_steps(cfg, params, batches, make_step, mesh=None, accum=1):
    """(losses, weights after the steps, the gradient at each step's
    weights) of the JAX step ``make_step(optimizer)`` from *params* (its
    state laid out on *mesh* when given)."""
    tx = jtrain.make_optimizer(lr=STEP_LR)
    if mesh is None:
        state = jtrain.TrainState(jax.tree.map(jnp.asarray, params),
                                  tx.init(params), jnp.zeros((), jnp.int32))
    else:
        state, tx = jtrain.init_state(jax.random.PRNGKey(0), cfg, mesh,
                                      optimizer=tx)
        state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = make_step(tx)
    grad = _jax_grad(cfg, accum)
    losses, grads = [], []
    for batch in batches:
        batch = [jnp.asarray(x) for x in batch]
        grads.append(jax.tree.map(np.asarray, grad(state.params, *batch)))
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params), grads


@pytest.fixture(scope="module")
def jax_runs(trees):
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        if name in STEPS:
            over, axes, shape = STEPS[name]
            cfg = _jcfg(KW, over)
            mesh = make_mesh(dict({"dp": 1, "sp": 1, "tp": 1}, **axes))
            cache[name] = _jax_steps(
                cfg, trees[name], _batches(shape, 2),
                lambda tx: jtrain.make_train_step(cfg, mesh, optimizer=tx,
                                                  attention="dense"), mesh)
        else:
            over, _axes, micro, shape, steps = PIPES[name]
            cfg = _jcfg(PIPE_KW, over)
            accum = micro if cfg.moe_capacity_factor > 0 else 1

            def plain(tx):
                return jax.jit(jtrain.make_update_step(
                    lambda p, t, y: jmodel.next_token_loss(p, t, y, cfg),
                    tx, accum_steps=accum))

            cache[name] = _jax_steps(cfg, trees[name],
                                     _batches(shape, steps), plain,
                                     accum=accum)
        return cache[name]

    return get


def _check_grads(got, want):
    def check(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, got, want)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_ep_step_matches_jax(world, trees, jax_runs, name):
    """Both steps' losses, on every rank, and each weight's change over
    them (experts gathered over ep) against the JAX step on its mesh."""
    want_losses, want_params, jgrads = jax_runs(name)
    got = world[0]["train"][STEP_NAMES.index(name)]
    for r in world:
        assert r["train"][STEP_NAMES.index(name)]["losses"] == \
            got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert_updates_match(trees[name], got["params"], trees[name],
                         want_params, jgrads, MESH_UPDATE_TOL)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_ep_gradient_and_global_norm_match_jax(world, trees, jax_runs,
                                               name):
    """The gradient the ep step hands its optimizer (summed over dp, never
    over ep or tp: the router's part through the combine is summed inside
    the block) against ``jax.grad``, and the global norm (expert leaves'
    squares summed over ep, the replicated router, attention, norms,
    embed and head counted once) against ``optax.global_norm``."""
    _losses, _params, jgrads = jax_runs(name)
    i = STEP_NAMES.index(name)
    _check_grads(world[0]["train"][i]["probe"]["grads"], jgrads[0])
    want_norm = float(optax.global_norm(jgrads[0]))
    for r in world:
        assert r["train"][i]["probe"]["norm"] == pytest.approx(
            want_norm, rel=GRAD_TOL)


@pytest.mark.parametrize("name", PIPE_NAMES)
def test_ep_pipeline_matches_jax(world, trees, jax_runs, name):
    """The pipelined step with experts on ep: losses on every rank,
    weights' changes, and the gradient and its norm at the first step,
    against the JAX one-device step (per microbatch under capacity
    dispatch)."""
    want_losses, want_params, jgrads = jax_runs(name)
    i = PIPE_NAMES.index(name)
    got = world[0]["pipeline"][i]
    for r in world:
        assert r["pipeline"][i]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert_updates_match(trees[name], got["params"], trees[name],
                         want_params, jgrads, MESH_UPDATE_TOL)
    _check_grads(got["probe"]["grads"], jgrads[0])
    assert got["probe"]["norm"] == pytest.approx(
        float(optax.global_norm(jgrads[0])), rel=GRAD_TOL)


@pytest.mark.parametrize("case", range(len(PREFETCH)))
def test_prefetch_to_mesh_yields_local_blocks_in_order(world, case):
    """Each rank's prefetched blocks are ``local_batch``'s blocks of the
    same batches, in order, every tuple entry (tokens, targets, and the
    packed weights) kept."""
    mesh, batches = PREFETCH[case]
    for r in world:
        got = r["prefetch"][case]
        assert len(got["got"]) == len(batches)
        for g, w, b in zip(got["got"], got["want"], batches):
            assert len(g) == len(b)
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)


def test_prefetch_feeds_the_ep_step(world):
    """The {dp 2, ep 4} step fed by ``prefetch_to_mesh`` takes the
    prefetched blocks as they are and gives the losses of the step fed
    the global batches."""
    want = world[0]["train"][0]["losses"]
    for r in world:
        assert r["prefetched_step"] == want
