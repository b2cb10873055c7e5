"""The port's flash attention (plain versions and the autograd function, on
the CPU) against the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs: forward out and lse, gradients, and the ring's use of
the backward with a global out / lse / cotangent."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module, not the function of the same name that kubetpu.ops exports
jflash = importlib.import_module("kubetpu.ops.flash_attention")
from kubetpu_torch.ops import flash_attention as tflash  # noqa: E402

torch.set_num_threads(1)

B, S, H = 2, 64, 4
BLOCK = 16          # the Pallas kernels' tile; windows 8 and 37 cut across it
CASES = {"causal": (True, 0), "window8": (True, 8), "window37": (True, 37),
         "noncausal": (False, 0)}


def _inputs(d, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, d)).astype(np.float32)
            for _ in range(n)]


def _jax_flash(causal, window):
    return functools.partial(jflash.flash_attention, block_q=BLOCK,
                             block_k=BLOCK, interpret=True, causal=causal,
                             window=window)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas_interpret(case, d):
    """out and lse within 2e-5 (f32; the two sum in different orders)."""
    causal, window = CASES[case]
    q, k, v = _inputs(d)[:3]
    j_out, j_lse = jflash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), BLOCK, BLOCK, True,
        causal, window)
    t_out, t_lse = tflash.flash_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, window)
    assert tuple(t_lse.shape) == (B * H, S, 1)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad(case, d):
    """torch.autograd through the port's flash_attention against jax.grad of
    the Pallas one, loss = sum(out * cotangent): within 2e-4."""
    causal, window = CASES[case]
    q, k, v, cot = _inputs(d, seed=1)
    jf = _jax_flash(causal, window)

    def jloss(q, k, v):
        return jnp.sum(jf(q, k, v) * jnp.asarray(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, j in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("d", [16, 32])
def test_noncausal_backward_with_global_residuals(d):
    """The ring's use of the backward: a non-causal step with an out / lse /
    cotangent that are not this block's own (here a causal forward's lse,
    which does not cover the non-causal scores — the clamp must hold the
    probabilities at 1 and keep everything finite)."""
    q, k, v, g = _inputs(d, seed=2)
    j_out, j_lse = jflash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), BLOCK, BLOCK, True,
        True, 0)
    j_out = j_out * 0.5          # a stand-in for the merged global output
    jg = jflash._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse,
        jnp.asarray(g), BLOCK, BLOCK, True, causal=False)
    tg = tflash.flash_backward(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(j_out)),
        torch.from_numpy(np.array(j_lse)), torch.from_numpy(g),
        causal=False)
    for t, j in zip(tg, jg):
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4,
                                   rtol=2e-4)


def _counts():
    return (tflash.flash_forward.launches, tflash.flash_forward.wgmma_launches,
            tflash.flash_backward.dq_launches,
            tflash.flash_backward.dq_wgmma_launches,
            tflash.flash_backward.dkv_launches,
            tflash.flash_backward.dkv_wgmma_launches)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(16, seed=3))
    before = _counts()
    out, lse = tflash.flash_forward(q, k, v, True, 8)
    ref_out, ref_lse = tflash.flash_forward_reference(q, k, v, True, 8)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    grads = tflash.flash_backward(q, k, v, out, lse, g, True, 8)
    refs = tflash.flash_backward_reference(q, k, v, out, lse, g, True, 8)
    assert all(torch.equal(a, b) for a, b in zip(grads, refs))
    assert _counts() == before


def test_bf16_keeps_the_dtype():
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(32, seed=4))
    out, lse = tflash.flash_forward(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(x.dtype == torch.bfloat16
               for x in tflash.flash_backward(q, k, v, out, lse, g))


def test_refuses_what_the_kernels_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(16, seed=5)[:3])
    with pytest.raises(ValueError, match="requires causal"):
        tflash.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_forward(q, k, v, True, -1)
    with pytest.raises(TypeError, match="dtype"):
        tflash.flash_forward(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_forward(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                             v)
    with pytest.raises(ValueError, match="shape"):
        tflash.flash_forward(q, k[:, :32], v)
    wide = torch.zeros((1, 4, 1, 264))
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_forward(wide, wide, wide)
    out, lse = tflash.flash_forward(q, k, v)
    with pytest.raises(TypeError, match="lse"):
        tflash.flash_backward(q, k, v, out, lse[:, :, 0], q)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_route_pins_the_instances_for_each_dtype_and_head_dim(dtype, d):
    """The tensor-core (wgmma) instances of all three kernels (forward, dQ
    and dK/dV) take bf16 and f16 at D 64 and 128; f32 (TF32 stays off for
    parity) and every other head dim take SIMT."""
    expected = ("wgmma" if dtype != torch.float32 and d in (64, 128)
                else "simt")
    assert tflash._route(dtype, d) == expected
    assert tflash._ROUTE_CODE[expected] == (1 if expected == "wgmma" else 0)
