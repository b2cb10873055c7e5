"""The port's ring attention against ``kubetpu.jobs.ring_attention.
make_ring_attention`` on the same numpy inputs: the dense, banded and flash
rings, causal and bidirectional, forward and the gradients of
sum(out * cot), within rtol=2e-4, atol=2e-5 (as the reference's own ring
test). The port runs in one 4-rank gloo world on the CPU (its flash ring on
the kernels' plain versions); the JAX side on a 4-device sp mesh, the flash
ring in Pallas interpret mode. Also the outlier-logits case and the
encoder under the bidirectional ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubetpu.jobs import encoder as jencoder
from kubetpu.jobs import model as jmodel
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.jobs.ring_attention import make_ring_attention

from torch_mesh_worlds import spawn

SP = 4
RTOL, ATOL = 2e-4, 2e-5
B, S, H, D = 2, 64, 4, 8

# (impl, causal, window, logit scale)
CASES = [("dense", True, 0, 1.0), ("dense", False, 0, 1.0),
         ("flash", True, 0, 1.0), ("flash", False, 0, 1.0),
         ("dense", True, 8, 1.0), ("flash", True, 16, 1.0),
         ("flash", True, 0, 5.0), ("flash", True, 0, 30.0)]
IDS = ["dense-causal", "dense-bidir", "flash-causal", "flash-bidir",
       "banded-w8", "banded-flash-w16", "flash-outlier-5x",
       "flash-outlier-30x"]
# at 30x logits only finiteness is meaningful for the gradients:
# exp(s - lse) amplifies f32 lse rounding by e^|s| in any implementation
# (the reference's test_ring_flash_gradients_finite_with_outlier_logits)
OUTLIER = IDS.index("flash-outlier-30x")
GRAD_CASES = [i for i in range(len(CASES)) if i != OUTLIER]
ENC_CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
               max_seq=64)


def _inputs(i, scale):
    rng = np.random.default_rng(100 + i)
    q, k, v, cot = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                    for _ in range(4))
    return q * scale, k * scale, v, cot


def _jax_ring(impl, causal, window):
    mesh = make_mesh({"dp": 1, "sp": SP, "tp": 1},
                     devices=jax.devices()[:SP])
    return make_ring_attention(mesh, impl=impl, block_q=8, block_k=8,
                               interpret=impl == "flash", causal=causal,
                               window=window)


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    cases = []
    for i, (impl, causal, window, scale) in enumerate(CASES):
        q, k, v, cot = _inputs(i, scale)
        cases.append(dict(impl=impl, causal=causal, window=window, q=q, k=k,
                          v=v, cot=cot))
    params = jmodel.init_params(jax.random.PRNGKey(0),
                                jmodel.ModelConfig(**ENC_CFG))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32),
                                           0, ENC_CFG["vocab"]))
    enc = dict(cfg=ENC_CFG, params=jax.tree.map(np.asarray, params),
               tokens=tokens)
    res = spawn("ring", SP, tmp_path_factory.mktemp("ring"),
                {"cases": cases, "encoder": enc})
    assert all(r["foreign"] == [] for r in res)
    return res, cases, (params, tokens)


def _whole(res, i, get):
    """The ranks' sequence blocks joined along S."""
    return np.concatenate([get(r["cases"][i]) for r in res], axis=1)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ring_forward_matches_jax(ring_world, i):
    res, cases, _ = ring_world
    impl, causal, window, _ = CASES[i]
    c = cases[i]
    want = jax.jit(_jax_ring(impl, causal, window))(c["q"], c["k"], c["v"])
    got = _whole(res, i, lambda r: r["out"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("i", GRAD_CASES, ids=[IDS[i] for i in GRAD_CASES])
def test_ring_gradients_match_jax(ring_world, i):
    """dq, dk, dv of sum(out * cot): the port's rings carry the cross-block
    parts home (the dense ring through autograd's reverse hops, the flash
    ring's dK/dV travelling with their block)."""
    res, cases, _ = ring_world
    impl, causal, window, _ = CASES[i]
    c = cases[i]
    ring = _jax_ring(impl, causal, window)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) * c["cot"]),
                            argnums=(0, 1, 2)))(c["q"], c["k"], c["v"])
    for j, w in enumerate(want):
        got = _whole(res, i, lambda r: r["grads"][j])
        np.testing.assert_allclose(got, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg="qkv"[j])


def test_ring_flash_gradients_finite_with_outlier_logits(ring_world):
    """Invisible ring steps score against a global lse that does not cover
    them; with 30x logits the backward's exp(min(s - lse, 0)) clamp keeps
    every gradient finite, on every rank."""
    res, _, _ = ring_world
    for r in res:
        for g in r["cases"][OUTLIER]["grads"]:
            assert np.isfinite(g).all()


def test_encoder_under_the_bidirectional_ring_matches_jax(ring_world):
    """encoder_forward with the causal=False ring, each rank's RoPE at its
    block's global positions, equals the JAX encoder under its ring."""
    res, _, (params, tokens) = ring_world
    ring = _jax_ring("dense", False, 0)
    want = jencoder.encoder_forward(params, jnp.asarray(tokens),
                                    jmodel.ModelConfig(**ENC_CFG),
                                    attn_fn=ring)
    got = np.concatenate([r["cases"][-1]["logits"] for r in res], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_banded_ring_refuses_a_window_past_the_block():
    import torch

    from kubetpu_torch.jobs.ring_attention import make_ring_local

    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="window <= S/sp"):
        make_ring_local("dense", None, window=9)(q, q, q)
    with pytest.raises(ValueError, match="requires causal"):
        make_ring_local("flash", None, causal=False, window=4)
    with pytest.raises(ValueError, match="unknown ring impl"):
        make_ring_local("sparse", None)
