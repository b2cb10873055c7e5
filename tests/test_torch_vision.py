"""The port's Vision Transformer against ``kubetpu.jobs.vision`` on the same
seeded weights and images, f32: ``patchify`` exactly, ``vit_forward``
(dense core, and the port's plain flash against the Pallas kernel in
interpret mode), ``vit_loss`` and the MoE aux term, the config's
validation, the parameter tree, and whole train steps against the JAX step
on a one-device mesh."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import data as jdata
from kubetpu.jobs import model as jmodel
from kubetpu.jobs import train as jtrain
from kubetpu.jobs import vision as jvit
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.ops import flash_attention as jflash_attention
from kubetpu_torch.jobs import data as tdata
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs import train as ttrain
from kubetpu_torch.jobs import vision
from kubetpu_torch.jobs.convert import (vit_params_from_numpy,
                                        vit_params_to_numpy)
from kubetpu_torch.ops.flash_attention import flash_attention
from test_torch_encoder import STEP_LR, assert_updates_match
from torch_mesh_worlds import MeshStub

torch.set_num_threads(1)

JCFG = jvit.VitConfig(
    image_size=16, patch_size=4, channels=3, n_classes=10,
    model=jmodel.ModelConfig(d_model=32, n_layers=2, n_heads=4, d_ff=64))
LOGIT_TOL = 1e-5        # f32 dense on both sides
FLASH_TOL = 2e-4        # the Pallas interpreter's tiled sums against ours


def port_cfg(jcfg, **model_over):
    fields = {f.name: getattr(jcfg.model, f.name)
              for f in dataclasses.fields(tmodel.ModelConfig)
              if f.name != "dtype"}
    fields.update(model_over)
    return vision.VitConfig(image_size=jcfg.image_size,
                            patch_size=jcfg.patch_size,
                            channels=jcfg.channels, n_classes=jcfg.n_classes,
                            model=tmodel.ModelConfig(**fields))


def _both(jcfg=JCFG, seed=0):
    jparams = jvit.init_vit_params(jax.random.PRNGKey(seed), jcfg)
    model = vit_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  port_cfg(jcfg), device="cpu")
    return jparams, model


def _images(b=3, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, b).astype(np.int32)
    return images, labels


def test_patchify_is_exact():
    img = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    got = vision.patchify(torch.from_numpy(img), port_cfg(JCFG)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvit.patchify(
        jnp.asarray(img), JCFG)))
    assert got.shape == (2, 16, 48)
    np.testing.assert_array_equal(got[0, 1], img[0, :4, 4:8].reshape(-1))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_forward_matches_the_reference(attention):
    jparams, model = _both()
    images, _ = _images()
    jattn = attn = None
    if attention == "flash":
        jattn = functools.partial(jflash_attention, block_q=16, block_k=16,
                                  interpret=True, causal=False)
        attn = functools.partial(flash_attention, causal=False)
    ref = np.asarray(jvit.vit_forward(jparams, jnp.asarray(images), JCFG,
                                      attn_fn=jattn))
    with torch.no_grad():
        got = vision.vit_forward(model, torch.from_numpy(images),
                                 port_cfg(JCFG), attn_fn=attn).numpy()
    assert got.shape == (3, 10) and got.dtype == np.float32
    tol = FLASH_TOL if attention == "flash" else LOGIT_TOL
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("aux", [0.0, 0.5])
def test_vit_loss_and_moe_aux_match_the_reference(aux):
    jcfg = dataclasses.replace(JCFG, model=dataclasses.replace(
        JCFG.model, n_experts=4, moe_aux_coeff=aux))
    jparams, model = _both(jcfg)
    images, labels = _images()
    ref = float(jvit.vit_loss(jparams, jnp.asarray(images),
                              jnp.asarray(labels), jcfg))
    got = float(vision.vit_loss(model, torch.from_numpy(images),
                                torch.from_numpy(labels), port_cfg(jcfg)))
    assert got == pytest.approx(ref, rel=1e-5)
    if aux:
        plain = float(vision.vit_loss(
            model, torch.from_numpy(images), torch.from_numpy(labels),
            port_cfg(jcfg, moe_aux_coeff=0.0)))
        assert got > plain                  # the aux term was added


def test_config_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="patch_size"):
        jvit.VitConfig(image_size=30, patch_size=4)
    with pytest.raises(ValueError, match="patch_size"):
        vision.VitConfig(image_size=30, patch_size=4)
    cfg = vision.VitConfig(image_size=224, patch_size=16)
    assert (cfg.n_patches, cfg.patch_dim) == (196, 768)


def test_parameter_tree_matches_the_reference():
    """``init_vit_params``' leaves have the JAX tree's names, shapes and
    scales; the tree crosses both ways exactly; a wrong shape is named."""
    jtree = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(0), JCFG))
    model = vision.init_vit_params(torch.Generator().manual_seed(0),
                                   port_cfg(JCFG), device="cpu")
    mine = vit_params_to_numpy(model)
    assert jax.tree.structure(mine) == jax.tree.structure(jtree)
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 mine, jtree)
    for name in ("patch_proj", "pos_embed", "head_cls"):
        assert np.std(mine[name]) == pytest.approx(np.std(jtree[name]),
                                                   rel=0.25)
    back = vit_params_to_numpy(vit_params_from_numpy(jtree, port_cfg(JCFG),
                                                     device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jtree)
    bad = dict(jtree, pos_embed=jtree["pos_embed"][:8])
    with pytest.raises(ValueError, match="pos_embed"):
        vit_params_from_numpy(bad, port_cfg(JCFG), device="cpu")


def test_vit_refuses_an_unknown_attention_and_a_mesh():
    with pytest.raises(ValueError, match="unknown vit attention"):
        vision.make_vit_train_step(port_cfg(JCFG), attention="falsh",
                                   device="cpu")
    # a mesh is taken; one whose tp does not divide the heads is refused
    with pytest.raises(ValueError, match="does not divide n_heads"):
        vision.make_vit_train_step(port_cfg(JCFG), mesh=MeshStub(tp=3),
                                   device="cpu")
    with pytest.raises(ValueError, match="does not divide n_heads"):
        vision.init_vit_state(torch.Generator(), port_cfg(JCFG),
                              mesh=MeshStub(tp=3), device="cpu")


@pytest.mark.parametrize("attention,remat", [("dense", False),
                                             ("flash", False),
                                             ("flash", True)])
def test_vit_train_step_matches_the_reference(attention, remat):
    """Two steps of each package's train step from the same weights on
    ``SyntheticImages`` batches (byte-equal in both packages), at lr
    STEP_LR: losses within 1e-5 relative and every weight's change within
    UPDATE_TOL of the JAX step's."""
    jcfg = dataclasses.replace(JCFG, model=dataclasses.replace(
        JCFG.model, remat=remat))
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    jopt = jtrain.make_optimizer(lr=STEP_LR)
    jstate, _ = jvit.init_vit_state(jax.random.PRNGKey(0), jcfg, mesh,
                                    optimizer=jopt)
    jstep = jvit.make_vit_train_step(jcfg, mesh, optimizer=jopt,
                                     attention=attention, interpret=True)
    jattn = None
    if attention == "flash":
        jattn = functools.partial(jflash_attention, block_q=64, block_k=64,
                                  interpret=True, causal=False)
    cfg = port_cfg(jcfg)
    opt = ttrain.make_optimizer(lr=STEP_LR)
    jbefore = jax.tree.map(np.array, jstate.params)
    state = ttrain.state_from_params(vit_params_from_numpy(
        jbefore, cfg, device="cpu"), opt)
    before = jax.tree.map(np.array, vit_params_to_numpy(state.params))
    step = vision.make_vit_train_step(cfg, opt, attention=attention,
                                      device="cpu")
    jit = jdata.SyntheticImages(16, 3, 10, seed=2).batches(4, seed=3)
    tit = tdata.SyntheticImages(16, 3, 10, seed=2).batches(4, seed=3)
    jgrads = []
    for _ in range(2):
        (ji, jl), (ti, tl) = next(jit), next(tit)
        assert ji.tobytes() == ti.tobytes() and jl.tobytes() == tl.tobytes()
        jgrads.append(jax.tree.map(np.asarray, jax.grad(jvit.vit_loss)(
            jstate.params, jnp.asarray(ji), jnp.asarray(jl), jcfg,
            attn_fn=jattn)))
        jstate, jloss = jstep(jstate, jnp.asarray(ji), jnp.asarray(jl))
        state, loss = step(state, ti, tl)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_updates_match(before, vit_params_to_numpy(state.params), jbefore,
                         jstate.params, jgrads)
