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
