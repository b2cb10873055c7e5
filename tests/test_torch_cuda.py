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


_PAGED_COUNTERS = ("launches", "split_launches", "combine_launches",
                   "wgmma_launches")


def _paged_counts():
    return tuple(getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS)


def _expected_moves(case, route):
    """How each of _PAGED_COUNTERS moves for one call on *route*: the
    wgmma chunk kernel is followed by a combine where it splits keys."""
    if route == "wgmma":
        kp = case[1]
        return (1, 0, int(pa._chunk_splits(case[0], kp.shape[2]) > 1), 1)
    return {"split": (1, 1, 1, 0), "simt": (1, 0, 0, 0)}[route]


def _run_paged(case, window, route):
    """The wrapper on *case*, checked against the plain version: the
    expected route ran (its counters moved, no other), f32 within 1e-5,
    bf16/f16 within a few roundings (the wgmma route also rounds P to the
    input dtype before P.V, as the flash forward does)."""
    q = case[0]
    assert pa._route(q, case[1], q.shape[1], window) == route
    before = _paged_counts()
    out = pa._call(*case, window)
    torch.cuda.synchronize()
    assert _paged_counts() == tuple(
        x + n for x, n in zip(before, _expected_moves(case, route)))
    ref = pa.paged_attention_reference(*case, window)
    tol = 1e-5 if q.dtype == torch.float32 else 2e-2
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("form", ["decode", "window", "chunk", "int8",
                                  "chunk_int8"])
@pytest.mark.parametrize("geom", [(8, 2, 128, 16), (4, 4, 64, 8),
                                  (4, 1, 256, 16)],
                         ids=["gqa4_d128", "mha_d64", "mqa_d256"])
def test_kernel_matches_plain_version(cuda, dtype, form, geom):
    """Every form on its route: decode (plain, windowed, int8) on the split
    route; dense bf16/f16 chunks at D 64/128 on the wgmma route; f32 and
    int8 chunks and D 256 chunks on SIMT."""
    h, h_kv, d, ps = geom
    t = 37 if form.startswith("chunk") else 1
    ctx = [200, 77, 1 + t, 150] if t > 1 else [200, 77, 1, 150]
    case = _case(cuda, dtype, "int8" in form, 4, t, h, h_kv, d, ps, ctx)
    window = 24 if form == "window" else 0
    route = ("split" if t == 1 else
             "wgmma" if form == "chunk" and dtype != torch.float32
             and d in (64, 128) else "simt")
    out = _run_paged(case, window, route)
    assert torch.all(out[-1] == 0)


# (dtype, int8, B, T, H, H_kv, D, ps, ctx_end, window): the new designs'
# edges
_ROUTE_CASES = {
    # ~3000-key contexts span many splits (24 of 128 keys); the last span
    # is ragged
    "long_decode_bf16": (torch.bfloat16, False, 4, 1, 8, 8, 128, 16,
                         [3000, 2817, 1, 2049], 0),
    "long_decode_f32": (torch.float32, False, 4, 1, 8, 2, 128, 16,
                        [3000, 2817, 1, 2049], 0),
    "long_decode_int8": (torch.bfloat16, True, 4, 1, 16, 16, 128, 16,
                         [3000, 2817, 1, 2049], 0),
    # page sizes that divide neither a key tile nor a 256-key span
    "ps5_decode": (torch.bfloat16, False, 4, 1, 8, 2, 128, 5,
                   [1303, 260, 1, 777], 0),
    "ps12_decode_int8": (torch.float16, True, 4, 1, 8, 2, 64, 12,
                         [1303, 260, 1, 777], 0),
    "ps5_chunk": (torch.bfloat16, False, 3, 100, 8, 2, 128, 5,
                  [1303, 260, 101], 0),
    "ps12_chunk": (torch.float16, False, 3, 100, 8, 8, 64, 12,
                   [1303, 260, 101], 0),
    # T = 256 chunks, rows straddling 64-row tiles at g = 1, 4 and 8
    "chunk256_g1": (torch.bfloat16, False, 2, 256, 16, 16, 128, 16,
                    [1024, 300], 0),
    "chunk256_g4": (torch.bfloat16, False, 2, 256, 8, 2, 128, 16,
                    [1024, 300], 0),
    "chunk256_g8": (torch.float16, False, 2, 256, 8, 1, 64, 16,
                    [1024, 300], 0),
    # enough 64-row blocks to fill the card: no key split, no combine
    "chunk256_b4_unsplit": (torch.bfloat16, False, 4, 256, 16, 16, 128, 16,
                            [1024, 300, 257, 700], 0),
    # bands of 300 and 200 keys that cross split boundaries
    "window_across_split": (torch.bfloat16, False, 4, 1, 8, 2, 128, 16,
                            [1000, 530, 1, 270], 300),
    "window_int8": (torch.bfloat16, True, 4, 1, 8, 8, 128, 16,
                    [1000, 530, 1, 270], 200),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_ROUTE_CASES))
def test_split_and_wgmma_routes_match_plain_version(cuda, name):
    """Each case has a hole inside slot 1's range and a fully unmapped last
    slot, which must write 0 (every split of the split route empty; every
    tile of the wgmma route masked)."""
    dtype, int8, b, t, h, h_kv, d, ps, ctx, window = _ROUTE_CASES[name]
    case = _case(cuda, dtype, int8, b, t, h, h_kv, d, ps, ctx, seed=5)
    route = "split" if t == 1 else "wgmma"
    if route == "wgmma":   # 132 SMs: 2 x 132 // 256 blocks = 1 share
        assert (pa._chunk_splits(case[0], h_kv) == 1) == name.endswith(
            "unsplit")
    out = _run_paged(case, window, route)
    assert torch.all(out[-1] == 0)
    if route == "split":
        # the plain version of the split route agrees too
        ref = pa.paged_attention_split_reference(*case, window)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


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
# summation order; bf16/f16: the SIMT instances compute in f32 from the same
# inputs and round once; the wgmma instances also round P (and dS) to the
# input dtype before their second product, as the TPU's one-pass bf16 dot
# does, which stays within a few roundings of the output
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
# windows 24 and 100 cut across the kernels' tiles (32, 64 and 128 rows)
FLASH_FORMS = {"causal": (True, 0), "window": (True, 24),
               "window100": (True, 100), "noncausal": (False, 0)}


def _flash_inputs(dev, dtype, b, s, h, d, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
            for _ in range(4)]


def _flash_counts(fa):
    return (fa.flash_forward.launches, fa.flash_backward.dq_launches,
            fa.flash_backward.dkv_launches, fa.flash_forward.wgmma_launches,
            fa.flash_backward.dq_wgmma_launches,
            fa.flash_backward.dkv_wgmma_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("form", list(FLASH_FORMS))
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 100, 129, 200, 257, 1000])
def test_flash_kernels_match_plain_versions(cuda, dtype, form, d, s):
    """No S here is a multiple of every tile (32, 64 and 128 rows): the
    ragged tile is masked; S = 1 leaves one row, S = 129 one row past a
    128-row tile. Forward out and lse, dQ, dK and dV each against
    the plain version on the same inputs; bf16/f16 at D 64/128 run the wgmma
    instances of all three kernels, the rest the SIMT ones."""
    from kubetpu_torch.ops import flash_attention as fa

    causal, window = FLASH_FORMS[form]
    q, k, v, g = _flash_inputs(cuda, dtype, 2, s, 3, d)
    before = _flash_counts(fa)
    out, lse = fa.flash_forward(q, k, v, causal, window)
    grads = fa.flash_backward(q, k, v, out, lse, g, causal, window)
    torch.cuda.synchronize()
    wgmma = int(dtype != torch.float32 and d in (64, 128))
    assert fa._route(dtype, d) == ("wgmma" if wgmma else "simt")
    assert _flash_counts(fa) == tuple(
        x + n for x, n in zip(before, (1, 1, 1, wgmma, wgmma, wgmma)))
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_backward_with_global_residuals(cuda, dtype):
    """The ring's use of the backward: a non-causal call with an out / lse /
    cotangent that are not its own (a causal forward's lse, which does not
    cover the non-causal scores): the clamp holds P at 1 where s > lse, on
    both routes, as in the plain version."""
    from kubetpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_inputs(cuda, dtype, 2, 200, 3, 64, seed=2)
    out, lse = fa.flash_forward(q, k, v, True, 0)
    out = (out.float() * 0.5).to(dtype)
    grads = fa.flash_backward(q, k, v, out, lse, g, causal=False)
    torch.cuda.synchronize()
    refs = fa.flash_backward_reference(q, k, v, out, lse, g, causal=False)
    tol = FLASH_TOL[dtype]
    for name, x, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(x).all(), name
        torch.testing.assert_close(x.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
def test_flash_autograd_runs_the_kernels_and_refuses_bad_inputs(cuda):
    from kubetpu_torch.ops import flash_attention as fa

    q, k, v, g = _flash_inputs(cuda, torch.bfloat16, 2, 80, 4, 64, seed=1)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before = _flash_counts(fa)
    out = fa.flash_attention(q, k, v)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    # bf16 at D 64: all three kernels through the wgmma instances
    assert _flash_counts(fa) == tuple(x + 1 for x in before)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
    qd = q.detach()
    with pytest.raises(ValueError, match="on"):
        fa.flash_forward(qd, k.detach().cpu(), v.detach())
    wide = torch.zeros((1, 8, 1, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(wide, wide, wide)
    assert fa.flash_forward.launches == before[0] + 1


@pytest.mark.gpu
def test_wgmma_route_raises_and_never_falls_back(cuda):
    """A wgmma instance that refuses a call (here a tensor 2 bytes off the
    16-byte alignment its cp.async loads need) raises; nothing retries it
    through the SIMT instance or the plain version, and no counter moves:
    the flash forward, dQ and dK/dV, the paged chunk's wgmma route, and the
    paged split route (misaligned pages)."""
    from kubetpu_torch.ops import flash_attention as fa

    shape = (1, 64, 2, 64)
    n = 64 * 2 * 64
    flat = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    k, v = (torch.zeros(shape, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    before = _flash_counts(fa)
    with pytest.raises(RuntimeError, match="forward \\(wgmma\\)"):
        fa.flash_forward(q, k, v)
    out, lse = fa.flash_forward(k, k, v)
    with pytest.raises(RuntimeError, match="dQ \\(wgmma\\)"):
        fa._launch_dq(q, k, v, k, lse, fa._delta(out, k), True, 0)
    with pytest.raises(RuntimeError, match="dK/dV \\(wgmma\\)"):
        fa._launch_dkv(q, k, v, k, lse, fa._delta(out, k), True, 0)
    torch.cuda.synchronize()
    after = _flash_counts(fa)
    assert after == (before[0] + 1, before[1], before[2], before[3] + 1,
                     before[4], before[5])

    # the paged chunk's wgmma route, and the split route's page loads
    q, kp, vp, table, pos = _case(cuda, torch.bfloat16, False, 2, 64, 4, 4,
                                  64, 16, [300, 90])
    flat = torch.zeros(q.numel() + 1, device=cuda, dtype=q.dtype)
    q_off = flat[1:].view(q.shape)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 2
    before = _paged_counts()
    with pytest.raises(RuntimeError, match="\\(wgmma\\)"):
        pa.paged_attention_chunk(q_off, kp, vp, table, pos)
    flat = torch.zeros(kp.numel() + 1, device=cuda, dtype=kp.dtype)
    kp_off = flat[1:].view(kp.shape)
    with pytest.raises(RuntimeError, match="split"):
        pa.paged_attention(q[:, 0].contiguous(), kp_off, vp, table, pos)
    torch.cuda.synchronize()
    assert _paged_counts() == before


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
