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
                   "wgmma_launches", "wgmma_int8_launches", "simt_launches")


def _paged_counts():
    return tuple(getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS)


def _expected_moves(case, route):
    """How each of _PAGED_COUNTERS moves for one call on *route*: the
    wgmma chunk kernel (its dense or its int8 instance, by the pool) is
    followed by a combine where it splits keys."""
    if route == "wgmma":
        kv, ksc = pa._pages(case[1])
        combine = int(pa._chunk_splits(case[0], kv.shape[2]) > 1)
        return (1, 0, combine, int(ksc is None), int(ksc is not None), 0)
    return {"split": (1, 1, 1, 0, 0, 0), "simt": (1, 0, 0, 0, 0, 1)}[route]


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
    route; bf16/f16 chunks at D 64/128 on the wgmma route, over dense and
    int8 pages; f32 chunks and D 256 chunks on SIMT."""
    h, h_kv, d, ps = geom
    t = 37 if form.startswith("chunk") else 1
    ctx = [200, 77, 1 + t, 150] if t > 1 else [200, 77, 1, 150]
    case = _case(cuda, dtype, "int8" in form, 4, t, h, h_kv, d, ps, ctx)
    window = 24 if form == "window" else 0
    route = ("split" if t == 1 else
             "wgmma" if dtype != torch.float32 and d in (64, 128)
             else "simt")
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
    # int8 chunks on the wgmma route's int8 instance: T 2 and 9 (one
    # 64-row block a kv head, 4 key shares) and T 256 (2 shares at g 1,
    # 4 at g 4); f16 at g 4 over 12-token pages, and bf16
    "int8_chunk_T2_g4_ps12": (torch.float16, True, 4, 2, 8, 2, 64, 12,
                              [1303, 260, 101, 40], 0),
    "int8_chunk_T9_g4_ps12": (torch.float16, True, 4, 9, 8, 2, 128, 12,
                              [1303, 260, 101, 40], 0),
    "int8_chunk_T256_g4_ps12": (torch.float16, True, 2, 256, 8, 2, 128, 12,
                                [1024, 300], 0),
    "int8_chunk_T256_bf16_g1": (torch.bfloat16, True, 2, 256, 16, 16, 128,
                                16, [1024, 300], 0),
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


def _pool(gen, dev, dtype, int8, n_pool, ps, h_kv, d):
    def randn():
        return torch.randn((n_pool, ps, h_kv, d), generator=gen)

    if int8:
        return (quantize_kv_chunk(randn().to(dev)),
                quantize_kv_chunk(randn().to(dev)))
    return randn().to(dev, dtype), randn().to(dev, dtype)


def _ring_case(dev, dtype, int8, h, h_kv, d, ps, window, ctx_end, seed=0):
    """Decode at ctx_end[i]-1 over the windowed server's ring table: slot
    i's logical pages all alias onto its own ring of ceil(window/ps) + 1
    physical pages (lp -> ring[lp % ring]), mapped up to its worst case;
    the last slot is unmapped."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    ring = -(-window // ps) + 1
    b = len(ctx_end)
    max_pages = max(-(-c // ps) for c in ctx_end) + 3
    perm = torch.randperm(b * ring + 1, generator=gen)
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for i in range(b - 1):
        rp = perm[i * ring:(i + 1) * ring]
        table[i] = rp[torch.arange(max_pages) % ring]
    pos = torch.tensor([c - 1 for c in ctx_end], dtype=torch.int32)
    q = torch.randn((b, 1, h, d), generator=gen).to(dev, dtype)
    kp, vp = _pool(gen, dev, dtype, int8, b * ring + 1, ps, h_kv, d)
    return q, kp, vp, table.to(dev), pos.to(dev)


_RING_CASES = {
    # (dtype, int8, H, H_kv, D, ps, window, ctx_end)
    "bf16_w512_ps16": (torch.bfloat16, False, 16, 16, 128, 16, 512,
                       [2000, 1024, 513, 300, 1]),
    "bf16_w24_ps16": (torch.bfloat16, False, 8, 2, 128, 16, 24,
                      [700, 33, 17, 1]),
    "f32_w8_ps4": (torch.float32, False, 4, 2, 64, 4, 8, [90, 9, 5, 1]),
    "int8_w100_ps12": (torch.float16, True, 8, 2, 64, 12, 100,
                       [1303, 260, 101, 1]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_RING_CASES))
def test_split_route_over_a_ring_aliased_table(cuda, name):
    """The windowed decode of the ring table: the call against the plain
    attention and the plain split route, and the split kernel's partials
    against ``_split_partials`` (spans whose keys all lie outside the band
    stay empty although their pages are mapped)."""
    dtype, int8, h, h_kv, d, ps, window, ctx = _RING_CASES[name]
    case = _ring_case(cuda, dtype, int8, h, h_kv, d, ps, window, ctx)
    out = _run_paged(case, window, "split")
    assert torch.all(out[-1] == 0)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), pa.paged_attention_split_reference(
            *case, window).float(), atol=tol, rtol=tol)
    q, kp, vp, table, pos = case
    part, ml = pa._launch_split(q, kp, vp, table, pos, window)
    torch.cuda.synchronize()
    ref_part, ref_ml = (x[:, 0] for x in pa._split_partials(
        q, kp, vp, table, pos, window, pa._SPLIT_KEYS))
    used = ref_ml[..., 1] > 0
    assert torch.equal(ml[..., 1] > 0, used)
    assert int(used.sum()) < used.numel()
    torch.testing.assert_close(ml[used], ref_ml[used], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(part[used], ref_part[used], atol=1e-3,
                               rtol=1e-3)
    assert (ml[~used][:, 0] == -1e30).all() and (ml[~used][:, 1] == 0).all()


def _shared_case(dev, dtype, int8, t, h, h_kv, d, ps, shared, tails, seed=0):
    """A prefill chunk at a prefix hit: every slot's table leads with the
    same *shared* physical pages (the tree's rows, read by all), then its
    own pages; slot i's T queries start at pos = shared * ps and its
    context ends tails[i] tokens later."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    b = len(tails)
    own = [-(-tl // ps) for tl in tails]
    n_pool = shared + sum(own) + 1
    perm = torch.randperm(n_pool, generator=gen)
    table = torch.full((b, shared + max(own) + 1), -1, dtype=torch.int32)
    used = shared
    for i, n in enumerate(own):
        table[i, :shared] = perm[:shared]
        table[i, shared:shared + n] = perm[used:used + n]
        used += n
    pos = torch.full((b,), shared * ps, dtype=torch.int32)
    q = torch.randn((b, t, h, d), generator=gen).to(dev, dtype)
    kp, vp = _pool(gen, dev, dtype, int8, n_pool, ps, h_kv, d)
    return q, kp, vp, table.to(dev), pos.to(dev)


_SHARED_CASES = {
    # (dtype, int8, T, H, H_kv, D, ps, shared pages, tails): the flagship's
    # 1024-token system prompt and a 64-token tail; two slots at once
    "wgmma_bf16_flagship": (torch.bfloat16, False, 64, 16, 16, 128, 16, 64,
                            [64, 64]),
    "wgmma_f16_gqa": (torch.float16, False, 37, 8, 2, 64, 8, 5, [37, 37]),
    "wgmma_int8": (torch.bfloat16, True, 48, 8, 2, 128, 16, 64, [48, 48]),
    "wgmma_int8_flagship": (torch.bfloat16, True, 64, 16, 16, 128, 16, 64,
                            [64, 64]),
    "simt_f32": (torch.float32, False, 21, 4, 2, 64, 8, 3, [21, 21]),
    # int8 pools on the SIMT route: f32 q, and a head dim of 256
    "simt_int8_f32": (torch.float32, True, 21, 4, 2, 64, 8, 3, [21, 21]),
    "simt_int8_d256": (torch.bfloat16, True, 48, 4, 1, 256, 16, 8,
                       [48, 48]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_SHARED_CASES))
def test_chunk_routes_at_a_prefix_hit_offset(cuda, name):
    """The wgmma and SIMT chunk routes with pos > 0 over tables whose
    leading rows are shared by both slots: against the plain version, and
    each slot's output equals the slot run alone."""
    dtype, int8, t, h, h_kv, d, ps, shared, tails = _SHARED_CASES[name]
    case = _shared_case(cuda, dtype, int8, t, h, h_kv, d, ps, shared, tails)
    route = name.split("_")[0]
    out = _run_paged(case, 0, route)
    q, kp, vp, table, pos = case
    alone = pa.paged_attention_chunk(q[1:], kp, vp, table[1:], pos[1:])
    torch.cuda.synchronize()
    torch.testing.assert_close(alone.float(), out[1:].float(), atol=2e-2,
                               rtol=2e-2)


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
    # the int8 instance: int8 values 1 byte off their 16-byte alignment
    _, k8, v8, _, _ = _case(cuda, torch.bfloat16, True, 2, 64, 4, 4, 64, 16,
                            [300, 90])
    flat = torch.zeros(k8[0].numel() + 1, device=cuda, dtype=torch.int8)
    k8_off = (flat[1:].view(k8[0].shape), k8[1])
    with pytest.raises(RuntimeError, match="\\(wgmma\\)"):
        pa.paged_attention_chunk(q, k8_off, v8, table, pos)
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


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_migration_snapshot_restores_byte_identical_on_the_card(cuda,
                                                                kv_int8):
    """A bf16 server's stream, snapshot mid-decode -> wire codec ->
    restored on a second server on the card: the restored pages, gathered
    through the target's table, are the source's bytes; the stream
    finishes with the unmigrated run's tokens; both sides ran the paged
    kernels (no plain attention on the card)."""
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.router.migration import (decode_snapshot,
                                                encode_snapshot)

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=2,
                      d_ff=512, max_seq=256, dtype=torch.bfloat16)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    prompt = torch.randint(0, cfg.vocab, (70,),
                           generator=torch.Generator().manual_seed(1)).tolist()

    def server():
        return PagedDecodeServer(cfg, model, n_slots=2, max_seq=256,
                                 max_new_tokens=16, page_size=16,
                                 prefill_budget=32, kv_int8=kv_int8,
                                 device="cuda")

    def live_pages(srv, rid):
        slot = srv._slot_rid.index(rid)
        n = srv._pages_needed(int(srv.pos[slot]) + 1)
        return srv._gather_phys_pages(srv._table[slot, :n])

    quiet = server()
    rid = quiet.enqueue(prompt)
    quiet.drain()
    want = quiet.pop_result(rid)
    src, dst = server(), server()
    rid = src.enqueue(prompt)
    while len(src._emitted.get(rid, [])) < 4:
        src.step()
    snap = src.snapshot_slot(rid)
    src.freeze_slot(rid)
    assert set(snap["pages"]) == ({"k_q", "k_s", "v_q", "v_s"} if kv_int8
                                  else {"k", "v"})
    before = live_pages(src, rid)
    counts = _paged_counts()
    rid2 = dst.restore_slot(decode_snapshot(*encode_snapshot(snap)))
    src.finish_migrated(rid, {"replica": "dst", "rid": rid2, "epoch": 1})
    after = live_pages(dst, rid2)
    for name, t in before.items():
        assert torch.equal(t, after[name]), name
    slot = dst._slot_rid.index(rid2)
    assert (int(dst.pos[slot]), int(dst.last[slot])) == (snap["pos"],
                                                         snap["last"])
    dst.drain()
    assert dst.pop_result(rid2) == want
    moved = [b - a for a, b in zip(counts, _paged_counts())]
    assert moved[1] > 0 and moved[5] == 0       # split decode, no SIMT
    src.check_invariants()
    dst.check_invariants()


# the speculative verify chunk: B = 8 slots, T = gamma + 1 queries a slot
_VERIFY_CASES = [(route, t, int8) for route in ("wgmma", "simt", "rows")
                 for t in (2, 5, 9) for int8 in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("route,t,int8", _VERIFY_CASES,
                         ids=[f"{r}_T{t}_{'int8' if i else 'bf16'}"
                              for r, t, i in _VERIFY_CASES])
def test_verify_route_candidates_match_plain_version(cuda, route, t, int8):
    """Each candidate route of the verify chunk — the wgmma chunk kernel,
    the SIMT chunk kernel, and the split route over the B*T queries as
    one-query rows — against the plain attention at B = 8, bf16 q, D 128,
    over bf16 and int8 pages; the fully unmapped last slot writes 0."""
    ctx = [600, 517, 300, 257, 130, 77, 40, 20]
    case = _case(cuda, torch.bfloat16, int8, 8, t, 16, 16, 128, 16, ctx,
                 seed=9)
    before = _paged_counts()
    out = pa._kernel(*case, 0, route=route)
    torch.cuda.synchronize()
    moved = tuple(b - a for a, b in zip(before, _paged_counts()))
    want = {"rows": (1, 1, 1, 0, 0, 0), "simt": (1, 0, 0, 0, 0, 1),
            "wgmma": _expected_moves(case, "wgmma")}[route]
    assert moved == want
    ref = pa.paged_attention_reference(*case, 0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.all(out[-1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_drop_page_writes_equal_the_row_filtered_writes(cuda, kv_int8):
    """The decode step's dropped writes (an unmapped page, a masked slot)
    go to the pool's drop page: logits and every addressable page are
    bit-equal to the path that filtered the kept rows out with
    ``torch.nonzero`` (a host sync) before writing them."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.decode import _layer
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import (_write_token_kv, init_page_pool,
                                          paged_forward_one)

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=2,
                      d_ff=512, max_seq=256, dtype=torch.bfloat16)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    n_pool, ps = 12, 16
    gen = torch.Generator(device="cuda").manual_seed(3)
    stores = init_page_pool(cfg, n_pool + 1, ps, kv_int8=kv_int8,
                            device="cuda")
    for t in (x for pool in stores
              for x in (pool if isinstance(pool, tuple) else (pool,))):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device="cuda"))
        else:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
    table = torch.tensor([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8],
                          [9, -1, -1, -1]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([40, 40, 63, 5], dtype=torch.int32, device="cuda")
    enable = torch.tensor([True, True, False, True], device="cuda")
    token = torch.tensor([1, 2, 3, 4], device="cuda")

    def clone(pools):
        return tuple(tuple(x.clone() for x in p) if isinstance(p, tuple)
                     else p.clone() for p in pools)

    def filtered(k_pages, v_pages):
        """The row-filtered write path the drop page replaces."""
        ps_ = (k_pages[0] if isinstance(k_pages, tuple) else k_pages).shape[2]
        pos_l = pos.long()
        lp = torch.clamp(pos_l // ps_, max=table.shape[1] - 1)
        phys = torch.gather(table, 1, lp[:, None])[:, 0].long()
        rows = torch.nonzero((phys >= 0) & enable)[:, 0]
        phys, offset = phys[rows], (pos_l % ps_)[rows]
        x = model.embed[token[:, None]]
        for i, layer in enumerate(model.blocks):
            k_l, v_l = _layer(k_pages, i), _layer(v_pages, i)
            h = model_lib.rms_norm(x, layer.ln1)
            q = torch.einsum("bsd,dhk->bshk", h, layer.wq)
            k = torch.einsum("bsd,dhk->bshk", h, layer.wk)
            v = torch.einsum("bsd,dhk->bshk", h, layer.wv)
            q = model_lib.rope(q, pos_l[:, None], cfg.rope_theta)
            k = model_lib.rope(k, pos_l[:, None], cfg.rope_theta)
            _write_token_kv(k_l, k[rows, 0], phys, offset)
            _write_token_kv(v_l, v[rows, 0], phys, offset)
            attn = pa.paged_attention(q[:, 0].contiguous(), k_l, v_l, table,
                                      pos)[:, None]
            x = x + torch.einsum("bshk,hkd->bsd", attn, layer.wo)
            x = x + model_lib._mlp(cfg, model_lib.rms_norm(x, layer.ln2),
                                   layer)[0]
        x = model_lib.rms_norm(x, model.ln_f)
        return torch.einsum("bsd,dv->bsv", x, model.head).float()[:, 0]

    old = clone(stores)
    with torch.no_grad():
        want = filtered(*old)
        got = paged_forward_one(cfg, model, token, *stores, table, pos,
                                attend=pa.paged_attention,
                                write_enable=enable)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    flat = [x for pool in stores
            for x in (pool if isinstance(pool, tuple) else (pool,))]
    flat_old = [x for pool in old
                for x in (pool if isinstance(pool, tuple) else (pool,))]
    for a, b in zip(flat, flat_old):
        assert torch.equal(a[:, :n_pool], b[:, :n_pool])


def _lora_model(dev, dtype, seed=0):
    """A small model at D = 128 (the split and wgmma routes) and three
    rank-8 adapters on it: two with B drawn N(0, 0.05), one all zero."""
    from kubetpu_torch.jobs.lora import LoraConfig, init_lora_params
    from kubetpu_torch.jobs.model import ModelConfig, init_params

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=2,
                      d_ff=512, max_seq=256, dtype=dtype)
    lcfg = LoraConfig(rank=8, alpha=16.0)
    model = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    ads = []
    for s in (1, 2, 3):
        a = init_lora_params(torch.Generator(device=dev).manual_seed(s), cfg,
                             lcfg, device=dev)
        if s < 3:
            gen = torch.Generator(device=dev).manual_seed(100 + s)
            for k, v in a["blocks"].items():
                if k.endswith("_b"):
                    a["blocks"][k] = (torch.randn(v.shape, generator=gen,
                                                  device=dev) * 0.05).to(dtype)
        ads.append(a)
    return cfg, lcfg, model, ads


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_packed_multi_lora_server_on_the_card(cuda, kv_int8):
    """A packed bf16 server, three tenants (the third on a zero adapter)
    beside the plain server on the same prompts: the zero tenant's tokens
    equal the plain server's exactly, every leg ran on the paged kernels
    (split decode, wgmma chunks, no SIMT), and the bookkeeping drains."""
    from kubetpu_torch.jobs.multi_lora import PagedMultiLoraDecodeServer
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cfg, lcfg, model, ads = _lora_model("cuda", torch.bfloat16)
    kw = dict(n_slots=3, max_seq=256, max_new_tokens=12, page_size=16,
              prefill_budget=32, kv_int8=kv_int8, device="cuda")
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in (40, 70, 100)]
    counts = _paged_counts()
    packed = PagedMultiLoraDecodeServer(cfg, model, lcfg, ads, **kw)
    rids = [packed.enqueue(p, adapter=a) for a, p in enumerate(prompts)]
    packed.drain()
    moved = [b - a for a, b in zip(counts, _paged_counts())]
    got = [packed.pop_result(r) for r in rids]
    plain = PagedDecodeServer(cfg, model, **kw)
    want = [plain.enqueue(p) for p in prompts]
    plain.drain()
    want = [plain.pop_result(r) for r in want]
    assert got[2] == want[2]
    assert got[0] != want[0] or got[1] != want[1]   # the adapters steer
    assert moved[1] > 0 and moved[5] == 0            # split, no SIMT
    assert (moved[4] if kv_int8 else moved[3]) > 0   # the wgmma chunks
    packed.check_invariants()
    assert packed._rid_adapter == {}


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_packed_legs_match_the_cpu_on_the_card(cuda, kv_int8):
    """One packed decode step and one 4-token chunk through a random pool,
    three rows on three adapters: the card (split and wgmma kernels, bf16
    weights) against the same legs on the CPU in f32 (plain attention),
    within bf16 noise; and each row equals its merged model's row on the
    card."""
    from kubetpu_torch.jobs.lora import merge_lora
    from kubetpu_torch.jobs.multi_lora import stack_adapters
    from kubetpu_torch.jobs.paged import (init_page_pool, paged_forward_chunk,
                                          paged_forward_one)

    cfg, lcfg, model, ads = _lora_model("cuda", torch.bfloat16)
    n_pool, ps = 12, 16
    gen = torch.Generator(device="cuda").manual_seed(3)
    stores = init_page_pool(cfg, n_pool + 1, ps, kv_int8=kv_int8,
                            device="cuda")
    flat = [x for pool in stores
            for x in (pool if isinstance(pool, tuple) else (pool,))]
    for t in flat:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device="cuda"))
        else:
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda")
                    * (0.02 if t.shape[-1] == 1 else 1.0))
    table = torch.tensor([[0, 1, 2, -1], [3, 4, 5, -1], [6, 7, 8, 9]],
                         dtype=torch.int32, device="cuda")
    pos = torch.tensor([40, 33, 60], dtype=torch.int32, device="cuda")
    ids = torch.tensor([0, 1, 2], device="cuda")
    stack = stack_adapters(lcfg, ads)
    tokens = torch.randint(0, cfg.vocab, (3, 4), generator=gen,
                           device="cuda")

    def legs(model_, stores_, stack_, dev, merged=None):
        def clone():
            return tuple(tuple(x.clone() for x in p) if isinstance(p, tuple)
                         else p.clone() for p in stores_)

        lora = None if merged else stack_
        args = dict(lora=lora, adapter_ids=None if merged else ids.to(dev),
                    lora_scale=lcfg.scale)
        one = paged_forward_one(cfg if dev == "cuda" else cpu_cfg, model_,
                                tokens[:, 0].to(dev), *clone(),
                                table.to(dev), pos.to(dev),
                                attend=pa.paged_attention, **args)
        chunk = paged_forward_chunk(cfg if dev == "cuda" else cpu_cfg,
                                    model_, tokens.to(dev), *clone(),
                                    table.to(dev), pos.to(dev),
                                    attend_chunk=pa.paged_attention_chunk,
                                    **args)
        return one.float().cpu(), chunk.float().cpu()

    import dataclasses

    from kubetpu_torch.jobs.model import Transformer

    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_model = Transformer(cpu_cfg, "cpu")
    cpu_model.load_state_dict({k: v.float().cpu()
                               for k, v in model.state_dict().items()})
    cpu_stores = tuple(
        tuple(x.cpu() for x in p) if isinstance(p, tuple)
        else p.float().cpu() for p in stores)
    cpu_stack = {"blocks": {k: v.float().cpu()
                            for k, v in stack["blocks"].items()}}
    counts = _paged_counts()
    with torch.no_grad():
        card = legs(model, stores, stack, "cuda")
        torch.cuda.synchronize()
        moved = [b - a for a, b in zip(counts, _paged_counts())]
        host = legs(cpu_model, cpu_stores, cpu_stack, "cpu")
        rows = [legs(merge_lora(model, ads[r], lcfg), stores, None, "cuda",
                     merged=True) for r in range(3)]
    assert moved[1] > 0 and moved[5] == 0
    assert (moved[4] if kv_int8 else moved[3]) > 0
    for got, want in zip(card, host):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 0.05 * scale
    for r in range(3):
        for got, want in zip(card, rows[r]):
            scale = float(want[r].abs().max())
            assert float((got[r] - want[r]).abs().max()) <= 0.05 * scale


@pytest.mark.gpu
def test_lora_step_on_the_card_matches_the_cpu(cuda):
    """Three LoRA steps of a small f32 model on the card (flash kernels)
    and on the CPU (plain versions) from the same weights and batches:
    per-step losses and the first step's A/B gradients agree; the base's
    bytes stay as they were on both."""
    from kubetpu_torch.jobs import lora as lora_lib
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.train import (TrainState, _trained_leaves,
                                          make_optimizer)
    from kubetpu_torch.ops import flash_attention as fa

    cfg, lcfg, _, _ = _lora_model("cpu", torch.float32)
    cfg = model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq=128)
    base_cpu = model_lib.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    start = lora_lib.init_lora_params(torch.Generator().manual_seed(1), cfg,
                                      lcfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for k, v in start["blocks"].items():
        if k.endswith("_b"):
            start["blocks"][k] = torch.randn(v.shape, generator=gen) * 0.05
    batches = [torch.randint(0, cfg.vocab, (2, 128), generator=gen)
               for _ in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        base = model_lib.Transformer(cfg, dev)
        base.load_state_dict(base_cpu.state_dict())
        before = {k: v.clone() for k, v in base.state_dict().items()}
        lora = {"blocks": {k: v.clone().to(dev).requires_grad_(True)
                           for k, v in start["blocks"].items()}}
        tokens, targets = batches[0].to(dev), batches[0].roll(-1, 1).to(dev)
        loss = model_lib.next_token_loss(
            lora_lib._merged_view(base, lora, lcfg), tokens, targets, cfg,
            lora_lib._resolve_attention("flash"))
        grads = torch.autograd.grad(loss, _trained_leaves(lora))
        opt = make_optimizer(lr=1e-3)
        state = TrainState(lora, opt.init(_trained_leaves(lora)))
        step = lora_lib.make_lora_train_step(cfg, lcfg, optimizer=opt,
                                             device=dev)
        fwd = fa.flash_forward.launches
        losses = []
        for b in batches:
            state, loss = step(state, base, b, b.roll(-1, 1))
            losses.append(float(loss))
        runs[dev] = dict(losses=losses, grads=[g.cpu() for g in grads],
                         fwd=fa.flash_forward.launches - fwd)
        for k, v in base.state_dict().items():
            assert torch.equal(v, before[k]), k
    assert runs["cuda"]["fwd"] == 3 * cfg.n_layers
    torch.testing.assert_close(runs["cuda"]["losses"], runs["cpu"]["losses"],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(runs["cuda"]["grads"], runs["cpu"]["grads"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_sampled_step_waits_on_its_own_event(cuda, overlap, monkeypatch):
    """The profiler on the card: a sampled step's device phase waits on
    the event its own dispatch recorded after the step's host copy (never
    ``torch.cuda.synchronize``); an un-sampled dispatched step makes no
    sync and a routed one exactly one; the tokens equal an unprofiled
    server's and the phases cover the sampled wall."""
    from kubetpu_torch.jobs import serving as serving_mod
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=2,
                      d_ff=512, max_seq=256, dtype=torch.bfloat16)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in (40, 70)]
    kw = dict(n_slots=2, max_seq=256, max_new_tokens=24, page_size=16,
              prefill_budget=32, overlap=overlap, device="cuda")

    def serve(server):
        rids = [server.enqueue(p) for p in prompts]
        server.drain()
        return [server.pop_result(r) for r in rids]

    want = serve(PagedDecodeServer(cfg, model, **kw))
    server = PagedDecodeServer(cfg, model, **kw)
    server.enable_profiler(sample_every=4)
    server.warmup()
    window = {"leg": None}
    counts = {"dispatch": [], "route": [], "device_sync": 0}
    dispatched, waited = [], []

    def counting(fn):
        def wrapper(*args, **kwargs):
            if window["leg"] is not None:
                counts[window["leg"]][-1] += 1
            return fn(*args, **kwargs)
        return wrapper

    def no_device_sync(*args, **kwargs):
        counts["device_sync"] += 1

    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        counting(torch.cuda.Event.synchronize))
    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    for leg in ("dispatch", "route"):
        fn = getattr(server, f"_{leg}_step")

        def windowed(*args, leg=leg, fn=fn):
            counts[leg].append(0)
            window["leg"] = leg
            try:
                out = fn(*args)
            finally:
                window["leg"] = None
            if leg == "dispatch":
                dispatched.append(out[0][1])
            return out
        setattr(server, f"_{leg}_step", windowed)
    real_wait = serving_mod._wait_staged
    monkeypatch.setattr(serving_mod, "_wait_staged",
                        lambda staged: (waited.append(staged[1]),
                                        real_wait(staged)))
    got = serve(server)
    monkeypatch.undo()
    assert got == want
    assert counts["device_sync"] == 0
    assert counts["dispatch"] == [0] * len(counts["dispatch"])
    assert counts["route"] == [1] * len(counts["dispatch"])
    s = server.profile_summary()
    assert s["sampled_steps"] >= 2 and 0 < len(waited) <= s["sampled_steps"]
    assert all(isinstance(e, torch.cuda.Event) for e in waited)
    assert all(any(e is d for d in dispatched) for e in waited)
    assert s["coverage"] >= 0.9, s


# -- int8 weights, mixture-of-experts and the rolling generate -------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_and_dequantize_on_the_card(cuda, dtype):
    """int8 values and scales of stacked, per-layer and whole-model
    quantization on the card byte-equal to the CPU's; dequantized weights
    equal; a quantized model serves through the card's legs."""
    from kubetpu_torch.jobs import quant
    from kubetpu_torch.jobs.model import ModelConfig, init_params

    gen = torch.Generator().manual_seed(0)
    for shape in ((64, 32), (2, 16, 4, 8), (2, 4, 16, 24)):
        w = torch.randn(shape, generator=gen).to(dtype)
        host, card = quant.quantize_tensor(w), quant.quantize_tensor(
            w.to("cuda"))
        assert torch.equal(card.scale.cpu(), host.scale), shape
        assert torch.equal(card.q.cpu(), host.q), shape
        assert torch.equal(card.dequantize().cpu(), host.dequantize()), shape
    # the KV entries' quantization too (the int8 pools' write path)
    kv = torch.randn(3, 16, 2, 64, generator=gen).to(dtype)
    for a, b in zip(quant.quantize_kv_chunk(kv),
                    quant.quantize_kv_chunk(kv.to("cuda"))):
        assert torch.equal(b.cpu(), a)
    cfg = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=1,
                      d_ff=256, n_experts=4, moe_capacity_factor=2.0,
                      moe_top_k=2, dtype=dtype)
    host = quant.quantize_params(init_params(
        torch.Generator().manual_seed(1), cfg, device="cpu"))
    card = quant.quantize_params(init_params(
        torch.Generator().manual_seed(1), cfg, device="cpu").to("cuda"))
    a, b = host.state_dict(), card.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k].cpu()), k
    assert quant.param_bytes(card) == quant.param_bytes(host)
    layer = quant.maybe_dequantize(card.blocks[1])
    assert torch.equal(layer.w_gate.cpu(),
                       quant.maybe_dequantize(host.blocks[1]).w_gate)


def _moe_layer(dev, seed=0, d=128, e=8, f=256):
    from types import SimpleNamespace

    gen = torch.Generator().manual_seed(seed)
    leaves = {"moe_router": torch.randn(d, e, generator=gen) * d ** -0.5,
              "w_gate": torch.randn(e, d, f, generator=gen) * d ** -0.5,
              "w_up": torch.randn(e, d, f, generator=gen) * d ** -0.5,
              "w_down": torch.randn(e, f, d, generator=gen) * f ** -0.5}
    return SimpleNamespace(**{k: v.to(dev).requires_grad_(True)
                              for k, v in leaves.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "top1", "top2_tight", "per_row"])
def test_moe_mlp_on_the_card_matches_the_cpu(cuda, mode):
    """Both dispatches (dense one-hot, capacity top-1 / top-2 / per row) in
    f32 on the card against the CPU: outputs, router probabilities and
    every gradient."""
    from kubetpu_torch.jobs import model as model_lib

    h = torch.randn(4, 33, 128, generator=torch.Generator().manual_seed(1))

    def run(dev):
        layer = _moe_layer(dev)
        x = h.to(dev).requires_grad_(True)
        if mode == "dense":
            out, probs = model_lib._moe_mlp(x, layer)
        else:
            cf, k = {"top1": (2.0, 1), "top2_tight": (0.5, 2),
                     "per_row": (1.0, 2)}[mode]
            out, probs = model_lib._moe_mlp_capacity(
                x, layer, cf, k, per_row=mode == "per_row")
        aux = model_lib._moe_aux_from_probs(probs, 2)
        loss = (out.square().sum() + aux)
        grads = torch.autograd.grad(loss, [x] + list(vars(layer).values()))
        return [t.detach().float().cpu() for t in (out, probs, *grads)]

    for got, want in zip(run("cuda"), run("cpu")):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_rolling_generate_on_the_card_matches_the_cpu(cuda, quantized):
    """The ring-cache rolling generate of a small f32 windowed model, the
    ring wrapping several times, on the card and on the CPU: equal greedy
    tokens, and equal to ``make_generate`` on the card."""
    from kubetpu_torch.jobs import decode, quant
    from kubetpu_torch.jobs.model import ModelConfig, init_params

    cfg = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, window=16)
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = init_params(torch.Generator().manual_seed(0), cfg,
                       device="cpu").to("cuda")
    if quantized:
        host, card = quant.quantize_params(host), quant.quantize_params(card)
    prompt = torch.randint(0, cfg.vocab, (3, 24),
                           generator=torch.Generator().manual_seed(2))
    gen = decode.make_rolling_generate(cfg)
    want = gen(host, prompt, 0, 40)
    got = gen(card, prompt.to("cuda"), 0, 40)
    assert torch.equal(got.cpu(), want)
    dense = decode.make_generate(cfg)(card, prompt.to("cuda"), 0, 40)
    assert torch.equal(got, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_moe_paged_server_on_the_card_matches_the_cpu(cuda, kv_int8):
    """A small f32 top-2 capacity MoE model behind the paged server on the
    card (paged kernels) and on the CPU (plain attention): equal greedy
    tokens, the paged kernels ran."""
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cfg = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, max_seq=256, n_experts=4, moe_top_k=2,
                      moe_capacity_factor=2.0)
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in (20, 45, 70)]
    kw = dict(n_slots=3, max_seq=256, max_new_tokens=12, page_size=16,
              prefill_budget=32, kv_int8=kv_int8)

    def serve(model, dev):
        server = PagedDecodeServer(cfg, model, device=dev, **kw)
        rids = [server.enqueue(p) for p in prompts]
        server.drain()
        server.check_invariants()
        return [server.pop_result(r) for r in rids]

    want = serve(host, "cpu")
    counts = _paged_counts()
    got = serve(host.to("cuda"), "cuda")
    moved = [b - a for a, b in zip(counts, _paged_counts())]
    assert got == want
    assert moved[1] > 0                               # split decode steps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoint_card_to_cpu_to_card(cuda, dtype, tmp_path):
    """A train state trained on the card, written by ``save_checkpoint``
    and by the ``AsyncCheckpointer`` (whose pinned snapshot must not see
    the steps taken after ``save``), restores onto the CPU and back onto
    the card byte-equal; training resumes on the card with the losses of
    the uninterrupted run within 1e-4 relative."""
    from kubetpu_torch.jobs import checkpoint as ckpt
    from kubetpu_torch.jobs import train
    from kubetpu_torch.jobs.data import SyntheticCorpus
    from kubetpu_torch.jobs.model import ModelConfig

    cfg = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                      d_ff=256, max_seq=128, dtype=dtype)
    state, opt = train.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    step = train.make_train_step(cfg, opt, device="cuda")
    it = SyntheticCorpus(cfg.vocab, seed=1).batches(2, 128, seed=2)
    batches = [next(it) for _ in range(6)]
    for b in batches[:2]:
        state, _ = step(state, *b)
    snap = [t.detach().clone() for t in ckpt._leaves(state)]
    ckpt.save_checkpoint(str(tmp_path / "sync"), state)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), state)
    straight = []
    for b in batches[2:]:
        state, loss = step(state, *b)
        straight.append(float(loss))
    saver.close()
    for name in ("sync", "async"):
        host, _ = train.init_state(torch.Generator().manual_seed(5), cfg,
                                   device="cpu")
        ckpt.restore_checkpoint(str(tmp_path / name), host)
        card, opt2 = train.init_state(
            torch.Generator(device="cuda").manual_seed(6), cfg,
            device="cuda")
        for src, cpu_t, card_t in zip(snap, ckpt._leaves(host),
                                      ckpt._leaves(card)):
            assert cpu_t.device.type == "cpu"
            assert torch.equal(cpu_t, src.cpu())
        ckpt.save_checkpoint(str(tmp_path / (name + "_cpu")), host)
        ckpt.restore_checkpoint(str(tmp_path / (name + "_cpu")), card)
        for src, t in zip(snap, ckpt._leaves(card)):
            assert t.device.type == "cuda" and torch.equal(t, src)
        step2 = train.make_train_step(cfg, opt2, device="cuda")
        resumed = []
        for b in batches[2:]:
            card, loss = step2(card, *b)
            resumed.append(float(loss))
        # the card's reductions may order sums differently run to run
        assert all(abs(a - b) <= 1e-4 * abs(b)
                   for a, b in zip(resumed, straight)), (resumed, straight)


@pytest.mark.gpu
def test_token_file_batches_feed_the_card(cuda, tmp_path):
    """``TokenFile`` batches (the loader built at first use) upload to the
    card as the train step's int64 tokens unchanged, and a train step and
    an eval step consume them."""
    import numpy as np

    from kubetpu_torch.jobs import native_data, train
    from kubetpu_torch.jobs.data import ByteTokenizer
    from kubetpu_torch.jobs.model import ModelConfig

    text = tmp_path / "t.txt"
    text.write_text("\n\n".join(f"document {i}: the quick brown fox jumps "
                                f"over the lazy dog {i * 7}" for i in
                                range(200)))
    n = ByteTokenizer().encode_file(str(text), str(tmp_path / "t.bin"))
    cfg = ModelConfig(vocab=258, d_model=128, n_layers=1, n_heads=2,
                      d_ff=256, max_seq=64)
    state, opt = train.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    step = train.make_train_step(cfg, opt, device="cuda")
    evaluate = train.make_eval_step(cfg, device="cuda")
    with native_data.TokenFile(str(tmp_path / "t.bin")) as tf:
        assert tf.num_tokens == n
        tokens, targets = next(tf.batches(4, 64, seed=3))
        up = torch.from_numpy(tokens).to("cuda", torch.int64)
        assert torch.equal(up.cpu(), torch.from_numpy(tokens).long())
        assert int(up.max()) < ByteTokenizer.vocab
        state, loss = step(state, tokens, targets)
        assert np.isfinite(float(loss))
        assert np.isfinite(float(evaluate(state.params, tokens, targets)))
