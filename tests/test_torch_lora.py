"""The port's LoRA fine-tuning (``kubetpu_torch.jobs.lora``, the port of
``tests/test_lora.py``): zero-delta init, adapter-only training with the
base untouched, merged export, the tiny parameter count, MLP targets on
dense models, config validation, GQA shapes and the accumulation refusal;
and three port steps against the JAX package's ``make_lora_train_step`` on
a one-device CPU mesh (losses and factors within 1e-4, f32), the same
weights crossing over through ``params_from_numpy`` / ``lora_from_numpy``.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import ModelConfig as JaxConfig
from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs import make_mesh
from kubetpu.jobs import lora as jlora
from kubetpu.jobs.train import TrainState as JaxTrainState
from kubetpu.jobs.train import make_optimizer as jax_make_optimizer
from kubetpu_torch.jobs import lora as tlora
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import (lora_from_numpy, lora_to_numpy,
                                        params_from_numpy, params_to_numpy)
from kubetpu_torch.jobs.train import (TrainState, _trained_leaves,
                                      make_optimizer)

torch.set_num_threads(1)

JCFG = JaxConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq=64)
CFG = tmodel.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64, max_seq=64)
JLCFG = jlora.LoraConfig(rank=4, alpha=8.0)
LCFG = tlora.LoraConfig(rank=4, alpha=8.0)


def port_base(seed=0, jcfg=JCFG, cfg=CFG):
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")


def jax_adapter(seed, jcfg=JCFG, lcfg=JLCFG):
    """A JAX adapter with a real effect: B drawn N(0, 0.05) (the init's B
    = 0 would make it the base model)."""
    lora = jlora.init_lora_params(jax.random.PRNGKey(seed), jcfg, lcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), len(lcfg.targets))
    for i, t in enumerate(lcfg.targets):
        b = lora["blocks"][f"{t}_b"]
        lora["blocks"][f"{t}_b"] = jax.random.normal(keys[i], b.shape,
                                                     b.dtype) * 0.05
    return lora


def batch(seed=2, b=4, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_lora_init_is_identity_and_merge_leaves_the_base():
    """B = 0 at init: the merged model reproduces the base bit for bit;
    merge_lora returns a new model and never writes the base."""
    _, base = port_base()
    before = snapshot(base)
    lora = tlora.init_lora_params(torch.Generator().manual_seed(1), CFG,
                                  LCFG, device="cpu")
    assert all(float(lora["blocks"][f"{t}_b"].abs().max()) == 0.0
               for t in LCFG.targets)
    tokens = torch.from_numpy(batch()[0]).long()
    merged = tlora.merge_lora(base, lora, LCFG)
    assert merged is not base
    torch.testing.assert_close(tmodel.forward(merged, tokens, CFG),
                               tmodel.forward(base, tokens, CFG),
                               rtol=0, atol=0)
    adapter = lora_from_numpy(jax.tree.map(np.asarray, jax_adapter(3)),
                              device="cpu")
    tlora.merge_lora(base, adapter, LCFG)
    for k, v in snapshot(base).items():
        assert torch.equal(v, before[k]), k


def test_merge_matches_the_jax_merge_mlp_targets_included():
    lcfg_j = jlora.LoraConfig(rank=2, targets=("wq", "wo", "w_gate",
                                               "w_down"))
    lcfg_t = tlora.LoraConfig(rank=2, targets=("wq", "wo", "w_gate",
                                               "w_down"))
    jparams, base = port_base()
    ad = jlora.init_lora_params(jax.random.PRNGKey(4), JCFG, lcfg_j)
    ad["blocks"] = {k: v + 0.03 for k, v in ad["blocks"].items()}
    want = jax.tree.map(np.asarray, jlora.merge_lora(jparams, ad, lcfg_j))
    got = params_to_numpy(tlora.merge_lora(
        base, lora_from_numpy(jax.tree.map(np.asarray, ad), device="cpu"),
        lcfg_t))
    for k in want["blocks"]:
        np.testing.assert_allclose(got["blocks"][k], want["blocks"][k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def jax_three_steps():
    """Three JAX LoRA steps from a random-B adapter (so A moves from step
    one) on a one-device mesh: (start adapter, base, losses, factors)."""
    jparams, _ = port_base()
    start = jax_adapter(5)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    opt = jax_make_optimizer(lr=1e-2)
    step = jlora.make_lora_train_step(JCFG, JLCFG, mesh, optimizer=opt)
    state = JaxTrainState(params=start, opt_state=opt.init(start),
                          step=jnp.zeros((), jnp.int32))
    start_np = jax.tree.map(np.asarray, start)
    losses = []
    for i in range(3):
        tokens, targets = batch(seed=10 + i)
        state, loss = step(state, jparams, tokens, targets)
        losses.append(float(loss))
    return start_np, jparams, losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_three_steps_match_the_jax_lora_step(jax_three_steps, attention):
    """Losses and trained factors within 1e-4 of the JAX step; the base's
    bytes unchanged; the optimizer state covers the adapter leaves
    only."""
    start, _, want_losses, want = jax_three_steps
    _, base = port_base()
    before = snapshot(base)
    lora = lora_from_numpy(start, device="cpu")
    for v in lora["blocks"].values():
        v.requires_grad_(True)
    opt = make_optimizer(lr=1e-2)
    state = TrainState(lora, opt.init(_trained_leaves(lora)))
    assert len(state.opt_state.mu) == len(LCFG.targets) * 2
    step = tlora.make_lora_train_step(CFG, LCFG, optimizer=opt,
                                      attention=attention, device="cpu")
    losses = []
    for i in range(3):
        state, loss = step(state, base, *batch(seed=10 + i))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-4)
    got = lora_to_numpy(state.params)
    for k in want["blocks"]:
        np.testing.assert_allclose(got["blocks"][k], want["blocks"][k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k, v in snapshot(base).items():
        assert torch.equal(v, before[k]), k
    assert not any(p.requires_grad for p in base.parameters())


def test_lora_trains_and_base_is_untouched():
    """Fine-tuning drops the loss on one batch while the base stays
    frozen; the merged export continues the descent."""
    _, base = port_base()
    before = snapshot(base)
    state, opt = tlora.init_lora_state(torch.Generator().manual_seed(1), CFG,
                                       LCFG, optimizer=make_optimizer(lr=1e-2),
                                       device="cpu")
    step = tlora.make_lora_train_step(CFG, LCFG, optimizer=opt,
                                      attention="dense", device="cpu")
    tokens, targets = batch(seed=2)
    losses = []
    for _ in range(12):
        state, loss = step(state, base, tokens, targets)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    for k, v in snapshot(base).items():
        assert torch.equal(v, before[k]), k
    assert any(float(state.params["blocks"][f"{t}_b"].detach().abs().max())
               > 0 for t in LCFG.targets)
    merged = tlora.merge_lora(base, state.params, LCFG)
    tt, tg = (torch.from_numpy(x).long() for x in (tokens, targets))
    with torch.no_grad():
        final = float(tmodel.next_token_loss(merged, tt, tg, CFG))
        base_loss = float(tmodel.next_token_loss(base, tt, tg, CFG))
    assert final <= losses[-1] + 1e-3, (final, losses[-1])
    assert final < base_loss * 0.9


def test_lora_param_count_is_tiny():
    lora = tlora.init_lora_params(torch.Generator().manual_seed(1), CFG,
                                  LCFG, device="cpu")
    L, d, r = CFG.n_layers, CFG.d_model, LCFG.rank
    assert tlora.lora_param_count(lora) == 4 * L * (d * r + r * d)
    assert tlora.lora_param_count(lora) == jlora.lora_param_count(
        jlora.init_lora_params(jax.random.PRNGKey(1), JCFG, JLCFG))
    # flagship dims (vocab 32k, d 2048, 12 layers, d_ff 5632), rank 8
    Lf, df, vf, ff = 12, 2048, 32000, 5632
    base_f = vf * df * 2 + Lf * (2 * df + 4 * df * df + 3 * df * ff) + df
    assert 4 * Lf * (df * 8 + 8 * df) / base_f < 0.005


def test_lora_mlp_targets_dense_only():
    lcfg = tlora.LoraConfig(rank=2, targets=("wq", "w_gate", "w_down"))
    lora = tlora.init_lora_params(torch.Generator().manual_seed(0), CFG,
                                  lcfg, device="cpu")
    assert lora["blocks"]["w_gate_b"].shape == (CFG.n_layers, 2, CFG.d_ff)
    assert lora["blocks"]["w_down_a"].shape == (CFG.n_layers, CFG.d_ff, 2)
    # MoE configs refuse MLP targets (no adapter layout over the experts)
    with pytest.raises(ValueError, match="MoE"):
        tlora.init_lora_params(torch.Generator().manual_seed(0),
                               dataclasses.replace(CFG, n_experts=2), lcfg,
                               device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tlora._check_targets(SimpleNamespace(n_experts=2), lcfg)
    tlora._check_targets(SimpleNamespace(n_experts=2), LCFG)


def test_lora_config_validation():
    with pytest.raises(ValueError):
        tlora.LoraConfig(rank=0)
    with pytest.raises(ValueError):
        tlora.LoraConfig(targets=("wq", "nope"))
    with pytest.raises(ValueError):
        tlora.LoraConfig(targets=())
    assert tlora.LoraConfig(rank=8, alpha=16).scale == 2.0


def test_lora_gqa_shapes_follow_kv_heads():
    cfg = dataclasses.replace(CFG, n_kv_heads=2)
    jcfg = dataclasses.replace(JCFG, n_kv_heads=2)
    lora = tlora.init_lora_params(torch.Generator().manual_seed(0), cfg,
                                  LCFG, device="cpu")
    jl = jlora.init_lora_params(jax.random.PRNGKey(0), jcfg, JLCFG)
    assert {k: tuple(v.shape) for k, v in lora["blocks"].items()} == {
        k: tuple(v.shape) for k, v in jl["blocks"].items()}
    assert lora["blocks"]["wk_b"].shape == (cfg.n_layers, LCFG.rank, 2,
                                            cfg.head_dim)
    _, base = port_base(1, jcfg, cfg)
    tokens = torch.from_numpy(batch(b=2, s=8)[0]).long()
    torch.testing.assert_close(
        tmodel.forward(tlora.merge_lora(base, lora, LCFG), tokens, cfg),
        tmodel.forward(base, tokens, cfg), rtol=0, atol=0)


def test_lora_accum_steps_rejected():
    with pytest.raises(NotImplementedError):
        tlora.make_lora_train_step(CFG, LCFG, accum_steps=2, device="cpu")
