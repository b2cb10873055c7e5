"""The port's sharded train step over {dp 2, sp 2, tp 2} against the JAX
package's ``make_train_step`` on its 8-device mesh, from the same weights
(``convert.shard_params`` of the JAX tree) and batches, two steps at lr
STEP_LR: the dense ring and the flash ring (the JAX kernels in interpret
mode, the port's plain versions on the CPU); window 8 (the banded ring)
with the vocab-parallel loss tail's ``loss_chunk``, label smoothing and
z-loss; and ``accum_steps`` with ``clip_norm`` and ``weighted``. Each
case's losses and each weight's change over the two steps are held to
JAX's, and the gradient the sharded step hands its optimizer (summed over
the ranks) and the clip's global norm to ``jax.grad`` and
``optax.global_norm`` of the JAX loss. The port runs in one 8-rank gloo
world; every rank must report the same losses. Multislice
{dcn 2, dp 1, sp 2, tp 2} equals {dp 2, sp 2, tp 2} bit for bit, and a
non-finite gradient on one tp rank skips the update on every rank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs.meshjob import make_mesh

from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import spawn

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
MESH = {"dp": 2, "sp": 2, "tp": 2}
MULTISLICE = {"dcn": 2, "dp": 1, "sp": 2, "tp": 2}
# losses: f32 on both sides, the sums in another order (1e-4 relative, as
# tests/test_torch_train.py); each weight's change over the two steps:
# within MESH_UPDATE_TOL of JAX's, by test_torch_encoder's
# assert_updates_match; the summed gradient: within GRAD_TOL of the leaf's
# largest reference element, the norm GRAD_TOL relative
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
# a tenth of a step. The tp and sp partial sums reorder the gradient's
# f32 sums; an element whose gradient at one step is ~1e-6 of its leaf's
# largest (and the clip's 0.05 takes elements down to ~1e-7) sits near
# Adam's eps = 1e-8, where g / (|g| + eps) turns that rounding into up to
# 2.6e-2 of a step over two steps (the worst element seen: one wq element
# of the pipeline's flash ring). A skipped update misses by a whole step.
MESH_UPDATE_TOL = 1e-3

# name: (config overrides, attention, port step options, optimizer options,
#        weighted, steps); options share a case where they compose, to
# keep the JAX compiles few
CASES = {
    "ring": ({}, "ring", {}, {}, False, 2),
    "ring_flash": ({}, "ring_flash", {}, {}, False, 2),
    "window8_loss_tail": ({"window": 8, "loss_chunk": 8,
                           "label_smoothing": 0.1, "z_loss": 1e-3},
                          "ring", {}, {}, False, 2),
    "accum2_clip_weighted": ({}, "ring", {"accum_steps": 2},
                             {"clip_norm": 0.05}, True, 2),
}
NAMES = list(CASES)


def _batches(n, weighted):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        tok = rng.integers(0, KW["vocab"], (4, 32))
        batch = (tok, np.roll(tok, -1, axis=1))
        if weighted:
            batch += ((rng.random((4, 32)) > 0.3).astype(np.float32),)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def params():
    jcfg = jmodel.ModelConfig(**KW)
    return jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def world(params, tmp_path_factory):
    cases = []
    for name in NAMES:
        over, attention, step_kw, opt, weighted, steps = CASES[name]
        cases.append(dict(cfg=dict(KW, **over), mesh=MESH,
                          attention=attention, params=params,
                          opt=dict(opt, lr=STEP_LR), probe=True,
                          batches=_batches(steps, weighted), **step_kw,
                          **({"weights": True} if weighted else {})))
    cases.append(dict(cases[0], mesh=MULTISLICE, probe=False))
    cases.append(dict(cases[0], batches=_batches(1, False), probe=False,
                      skip_nonfinite=True, plant_inf=True))
    res = spawn("train", 8, tmp_path_factory.mktemp("train"),
                {"cases": cases})
    assert all(r["foreign"] == [] for r in res)
    return res


def _jcfg(name):
    return dataclasses.replace(jmodel.ModelConfig(**KW), **CASES[name][0])


def _jax_grad(name):
    """The gradient of the JAX loss (its default attention core: the dense
    one, banded under a window) on one whole batch."""
    jcfg = _jcfg(name)

    def loss(params, tokens, targets, *weights):
        return jmodel.next_token_loss(params, tokens, targets, jcfg,
                                      weights=weights[0] if weights
                                      else None)

    return jax.jit(jax.grad(loss))


@pytest.fixture(scope="module")
def jax_runs(params):
    """name -> the JAX step's two losses, its weights after them and the
    gradients at each step's weights, each case run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_run(params, name)
        return cache[name]

    return get


def _jax_run(params, name):
    _over, attention, step_kw, opt, weighted, steps = CASES[name]
    jcfg = _jcfg(name)
    mesh = make_mesh(MESH)
    state, tx = jtrain.init_state(
        jax.random.PRNGKey(0), jcfg, mesh,
        optimizer=jtrain.make_optimizer(lr=STEP_LR, **opt))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    if attention == "ring_flash":
        attention = "ring_flash_interpret"
    step = jtrain.make_train_step(jcfg, mesh, optimizer=tx,
                                  attention=attention, weighted=weighted,
                                  block_q=8, block_k=8, **step_kw)
    grad, accum = _jax_grad(name), step_kw.get("accum_steps", 1)
    losses, grads = [], []
    for batch in _batches(steps, weighted):
        batch = [jnp.asarray(x) for x in batch]
        micro = batch[0].shape[0] // accum    # the step's gradient: the
        parts = [grad(state.params, *(x[i * micro:(i + 1) * micro]
                                      for x in batch))
                 for i in range(accum)]       # micro-batches' mean
        grads.append(jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0),
                                  *parts))
        state, loss = step(state, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params), grads


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_jax(world, params, jax_runs, name):
    """Both steps' losses (the second one after the first update), and
    each weight's change over the two steps, against the JAX step's."""
    i = NAMES.index(name)
    want_losses, want_params, jgrads = jax_runs(name)
    got = world[0]["cases"][i]
    for r in world:          # the global loss, on every rank
        assert r["cases"][i]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    assert_updates_match(params, got["params"], params, want_params, jgrads,
                         MESH_UPDATE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_gradient_and_clip_norm_match_jax(world, params, name):
    """The gradient the sharded step hands its optimizer (the ranks' parts
    summed: over dp and sp always, over tp never) against ``jax.grad`` of
    the JAX loss on the whole batch, and ``GradSync.sq_norm``'s global
    norm (tp-sharded leaves summed over tp, replicated ones once) against
    ``optax.global_norm`` of it, on every rank."""
    i = NAMES.index(name)
    _over, _attention, _kw, _opt, weighted, _steps = CASES[name]
    batch = [jnp.asarray(x) for x in _batches(1, weighted)[0]]
    want = _jax_grad(name)(jax.tree.map(jnp.asarray, params), *batch)
    want_norm = float(optax.global_norm(want))
    clip = CASES[name][3].get("clip_norm")
    assert clip is None or want_norm > clip      # the clip scales
    got = world[0]["cases"][i]["probe"]["grads"]

    def check(path, g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, got, want)
    for r in world:
        assert r["cases"][i]["probe"]["norm"] == pytest.approx(
            want_norm, rel=GRAD_TOL)


def test_multislice_equals_dp_exactly(world):
    """dcn and dp are both pure data axes: the same losses and weights,
    bit for bit (and the dp step matches JAX's above)."""
    ring, ms = world[0]["cases"][0], world[0]["cases"][len(NAMES)]
    assert ms["losses"] == ring["losses"]
    for k in ("embed", "ln_f", "head"):
        assert np.array_equal(ms["params"][k], ring["params"][k])
    for k in ring["params"]["blocks"]:
        assert np.array_equal(ms["params"]["blocks"][k],
                              ring["params"]["blocks"][k])


def test_nonfinite_on_one_tp_rank_skips_everywhere(world, params):
    """An inf in one tp rank's head shard: the loss is non-finite on every
    rank, no rank updates (the optimizer count stays 0) and the weights are
    the initial ones but for the planted element."""
    i = len(NAMES) + 1
    for r in world:
        got = r["cases"][i]
        assert not np.isfinite(got["losses"][0]) and got["count"] == 0
    got = world[0]["cases"][i]["params"]
    head = params["head"].copy()
    head[0, KW["vocab"] // 2] = np.inf      # tp rank 1's first column
    np.testing.assert_array_equal(got["head"], head)
    for k in params["blocks"]:
        np.testing.assert_array_equal(got["blocks"][k], params["blocks"][k])


def test_mesh_refusals():
    from kubetpu_torch.jobs import train as ttrain

    cfg = ttrain.ModelConfig(**KW)
    with pytest.raises(ValueError, match="ring"):
        ttrain._resolve_attention("flash", 0, _FakeMesh({"sp": 2}))
    with pytest.raises(ValueError, match="not taken"):
        ttrain.check_mesh(cfg, _FakeMesh({"pp": 2}))
    with pytest.raises(ValueError, match="does not divide n_experts"):
        ttrain.check_mesh(dataclasses.replace(cfg, n_experts=3),
                          _FakeMesh({"ep": 2}))
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.check_mesh(dataclasses.replace(cfg, n_kv_heads=1),
                          _FakeMesh({"tp": 2}))


class _FakeMesh:
    """The DeviceMesh surface the step's checks read."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = list(axes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, name):
        return 0
