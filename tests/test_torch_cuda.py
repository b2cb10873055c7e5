"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor ``kubetpu``, so it runs where only the
port is installed; there it is run without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""

import pytest
import torch

from kubetpu_torch.jobs.quant import quantize_kv_chunk
from kubetpu_torch.ops import paged_attention as pa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, int8, b, t, h, h_kv, d, ps, ctx_end, holes=True,
          seed=0):
    """Pages scattered over a shuffled pool; slot i's queries sit at
    ctx_end[i]-t .. ctx_end[i]-1; with *holes* one slot's table has an
    unmapped page inside its range and the last slot is fully unmapped."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pages = [(c + ps - 1) // ps for c in ctx_end]
    max_pages = max(pages) + 1
    n_pool = sum(pages) + 2
    perm = torch.randperm(n_pool, generator=gen)
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[used:used + n]
        used += n
    pos = torch.tensor([c - t for c in ctx_end], dtype=torch.int32)
    if holes:
        table[1, 1] = -1                   # a hole inside the visible range
        table[-1] = -1                     # inactive slot: writes 0

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    q = randn(b, t, h, d).to(dev, dtype)
    if int8:
        kp = quantize_kv_chunk(randn(n_pool, ps, h_kv, d).to(dev))
        vp = quantize_kv_chunk(randn(n_pool, ps, h_kv, d).to(dev))
    else:
        kp = randn(n_pool, ps, h_kv, d).to(dev, dtype)
        vp = randn(n_pool, ps, h_kv, d).to(dev, dtype)
    return q, kp, vp, table.to(dev), pos.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("form", ["decode", "window", "chunk", "int8",
                                  "chunk_int8"])
@pytest.mark.parametrize("geom", [(8, 2, 128, 16), (4, 4, 64, 8),
                                  (4, 1, 256, 16)],
                         ids=["gqa4_d128", "mha_d64", "mqa_d256"])
def test_kernel_matches_plain_version(cuda, dtype, form, geom):
    """f32 within 1e-5; bf16/f16 outputs within a few roundings."""
    h, h_kv, d, ps = geom
    t = 37 if form.startswith("chunk") else 1
    ctx = [200, 77, 1 + t, 150] if t > 1 else [200, 77, 1, 150]
    case = _case(cuda, dtype, "int8" in form, 4, t, h, h_kv, d, ps, ctx)
    window = 24 if form == "window" else 0
    before = pa.paged_attention.launches
    out = pa._call(*case, window)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(*case, window)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.all(out[-1] == 0)


@pytest.mark.gpu
def test_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    q, kp, vp, table, pos = _case(cuda, torch.bfloat16, False, 4, 1, 8, 2,
                                  128, 16, [40, 30, 20, 10])
    before = pa.paged_attention.launches
    out = pa.paged_attention(q[:, 0], kp, vp, table, pos)
    assert out.shape == q[:, 0].shape and out.dtype == q.dtype
    assert pa.paged_attention.launches == before + 1
    with pytest.raises(ValueError, match="on"):
        pa.paged_attention(q[:, 0], kp.cpu(), vp, table, pos)
    with pytest.raises(TypeError, match="dense pages"):
        pa.paged_attention(q[:, 0], kp.float(), vp, table, pos)
    assert pa.paged_attention.launches == before + 1


# -- flash attention: forward, dQ and dK/dV kernels --------------------------

# f32: the kernel and the plain version (cuBLAS, TF32 off) differ only in
# summation order; bf16/f16: both compute in f32 from the same inputs and
# round once, so they differ by about one rounding of the output
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
FLASH_FORMS = {"causal": (True, 0), "window": (True, 24),
               "noncausal": (False, 0)}


def _flash_inputs(dev, dtype, b, s, h, d, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
            for _ in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("form", list(FLASH_FORMS))
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_kernels_match_plain_versions(cuda, dtype, form, d):
    """S = 100 is not a multiple of the kernels' tile (32 or 64): the ragged
    tile is masked. Forward out and lse, dQ, dK and dV each against the
    plain version on the same inputs."""
    from kubetpu_torch.ops import flash_attention as fa

    causal, window = FLASH_FORMS[form]
    q, k, v, g = _flash_inputs(cuda, dtype, 2, 100, 3, d)
    before = (fa.flash_forward.launches, fa.flash_backward.dq_launches,
              fa.flash_backward.dkv_launches)
    out, lse = fa.flash_forward(q, k, v, causal, window)
    grads = fa.flash_backward(q, k, v, out, lse, g, causal, window)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward.dq_launches,
            fa.flash_backward.dkv_launches) == tuple(x + 1 for x in before)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal, window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    # the backward from the same residuals on both sides
    refs = fa.flash_backward_reference(q, k, v, out, lse, g, causal, window)
    for name, x, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert x.dtype == dtype and x.shape == q.shape, name
        torch.testing.assert_close(x.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_flash_autograd_runs_the_kernels_and_refuses_bad_inputs(cuda):
    from kubetpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_inputs(cuda, torch.bfloat16, 2, 80, 4, 64, seed=1)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = (fa.flash_forward.launches, fa.flash_backward.dq_launches,
              fa.flash_backward.dkv_launches)
    out = fa.flash_attention(q, k, v)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_backward.dq_launches,
            fa.flash_backward.dkv_launches) == tuple(x + 1 for x in before)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    qd = q.detach()
    with pytest.raises(ValueError, match="on"):
        fa.flash_forward(qd, k.detach().cpu(), v.detach())
    wide = torch.zeros((1, 8, 1, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(wide, wide, wide)
    assert fa.flash_forward.launches == before[0] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_through_the_flash_kernels_keeps_the_gradients(cuda, policy):
    """Rematerialized blocks re-run the forward kernel in the backward
    (the launch count doubles) and give the gradients of the plain run
    within 1e-5 (f32; the recompute is the same arithmetic)."""
    import dataclasses

    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.train import _resolve_attention
    from kubetpu_torch.ops import flash_attention as fa

    cfg = model_lib.ModelConfig(vocab=128, d_model=128, n_layers=2,
                                n_heads=2, n_kv_heads=1, d_ff=256,
                                max_seq=128)
    model = model_lib.init_params(torch.Generator(device="cuda").manual_seed(3),
                                  cfg, device=cuda).requires_grad_(True)
    gen = torch.Generator(device="cpu").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 96), generator=gen).to(cuda)
    targets = torch.randint(0, cfg.vocab, (2, 96), generator=gen).to(cuda)
    attn = _resolve_attention("flash")
    grads = {}
    for name, c in (("plain", cfg),
                    ("remat", dataclasses.replace(cfg, remat=True,
                                                  remat_policy=policy))):
        before = fa.flash_forward.launches
        loss = model_lib.next_token_loss(model, tokens, targets, c, attn)
        grads[name] = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        grads[name + "_fwd"] = fa.flash_forward.launches - before
    assert grads["plain_fwd"] == cfg.n_layers
    assert grads["remat_fwd"] == 2 * cfg.n_layers
    for a, b in zip(grads["remat"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
