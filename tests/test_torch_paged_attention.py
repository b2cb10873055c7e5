"""The port's paged attention against the JAX package: its plain version
(what the wrapper runs for CPU tensors) against the Pallas kernel run in
interpret mode and against the gather cores, over f32 and int8 pages,
windowed and not, one and four queries per slot, GQA and unmapped holes.
The CUDA kernel against the plain version is in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import paged as jpaged
from kubetpu.jobs.quant import quantize_kv_chunk as j_quantize
from kubetpu.ops.paged_attention import paged_attention as j_attend
from kubetpu.ops.paged_attention import paged_attention_chunk as j_attend_chunk
from kubetpu_torch.jobs import paged as tpaged
from kubetpu_torch.ops import paged_attention as tops

torch.set_num_threads(1)

TABLE = np.array([[5, 2, 7, -1],
                  [0, -1, -1, -1],
                  [9, 8, 1, 3]], np.int32)


def _inputs(t, seed=1, b=3, h=4, h_kv=2, d=8, ps=4, n_pool=10):
    """q (B, T, H, D) and f32 pools from numpy; GQA g = 2; the table has
    unmapped holes; positions mid-page, first-page and table-full."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pool, ps, h_kv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pool, ps, h_kv, d)).astype(np.float32)
    pos = np.array([9, 2, 15] if t == 1 else [8, 0, 12], np.int32)
    return q, kp, vp, pos


def _pools(kp, vp, int8):
    """(jax pools, torch pools): dense, or the JAX package's int8 pairs
    handed to both sides byte for byte."""
    if not int8:
        return ((jnp.asarray(kp), jnp.asarray(vp)),
                (torch.from_numpy(kp), torch.from_numpy(vp)))
    jk, jv = j_quantize(jnp.asarray(kp)), j_quantize(jnp.asarray(vp))
    tk = tuple(torch.from_numpy(np.array(x)) for x in jk)
    tv = tuple(torch.from_numpy(np.array(x)) for x in jv)
    return (jk, jv), (tk, tv)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 3, 8])
def test_decode_form_matches_pallas_and_gather_core(int8, window):
    q, kp, vp, pos = _inputs(1)
    (jk, jv), (tk, tv) = _pools(kp, vp, int8)
    jt, jpos = jnp.asarray(TABLE), jnp.asarray(pos)
    pallas = np.asarray(j_attend(
        jnp.asarray(q[:, 0]), jk, jv, jt, jpos, window=window,
        interpret=True))
    gather = np.asarray(jpaged._attend_paged(jnp.asarray(q[:, 0]), jk, jv,
                                             jt, jpos, window=window))
    out = tops.paged_attention(torch.from_numpy(q[:, 0]), tk, tv,
                               torch.from_numpy(TABLE),
                               torch.from_numpy(pos), window=window).numpy()
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(out, gather, atol=1e-5)
    # the port's gather core too
    tg = tpaged._attend_paged(torch.from_numpy(q[:, 0]), tk, tv,
                              torch.from_numpy(TABLE), torch.from_numpy(pos),
                              window=window).numpy()
    np.testing.assert_allclose(tg, gather, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_chunk_form_matches_pallas_and_gather_core(int8):
    q, kp, vp, pos = _inputs(4)
    (jk, jv), (tk, tv) = _pools(kp, vp, int8)
    jt, jpos = jnp.asarray(TABLE), jnp.asarray(pos)
    pallas = np.asarray(j_attend_chunk(
        jnp.asarray(q), jk, jv, jt, jpos, interpret=True))
    gather = np.asarray(jpaged._attend_paged_chunk(jnp.asarray(q), jk, jv,
                                                   jt, jpos))
    out = tops.paged_attention_chunk(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(TABLE),
                                     torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(out, gather, atol=1e-5)
    tg = tpaged._attend_paged_chunk(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(TABLE),
                                    torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(tg, gather, atol=1e-5)


def test_row_that_sees_no_key_is_zero():
    """An inactive slot (all -1 table) writes 0, like the Pallas kernel,
    which skips every unmapped page."""
    q, kp, vp, pos = _inputs(1)
    table = TABLE.copy()
    table[1] = -1
    pallas = np.asarray(j_attend(
        jnp.asarray(q[:, 0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(pos), interpret=True))
    out = tops.paged_attention(torch.from_numpy(q[:, 0]),
                               torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(table),
                               torch.from_numpy(pos)).numpy()
    assert np.all(out[1] == 0.0) and np.all(pallas[1] == 0.0)
    np.testing.assert_allclose(out, pallas, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 3, 8])
@pytest.mark.parametrize("span_pages", [1, 3, 16])
def test_split_reference_matches_plain_version_and_pallas(span_pages, window,
                                                          int8):
    """The split route's plain version (partials per span of keys, merged
    as the combine kernel merges them) against the one-pass plain version
    and the Pallas kernel in interpret mode: f32, within 1e-5. Spans of one
    page leave most spans of the short slots empty (slot 1 sees one page;
    keys past pos and below the band are empty spans too); 16 pages cover
    the whole table in one span."""
    q, kp, vp, pos = _inputs(1)
    (jk, jv), (tk, tv) = _pools(kp, vp, int8)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(TABLE),
            torch.from_numpy(pos))
    split = tops.paged_attention_split_reference(*args, window=window,
                                                 split_keys=4 * span_pages)
    plain = tops.paged_attention_reference(*args, window=window)
    pallas = np.asarray(j_attend(
        jnp.asarray(q[:, 0]), jk, jv, jnp.asarray(TABLE), jnp.asarray(pos),
        window=window, interpret=True))
    assert split.shape == plain.shape
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(split[:, 0].numpy(), pallas, atol=1e-5)


def test_split_reference_row_that_sees_no_key_is_zero():
    """A slot whose table is all -1 has only empty spans: the merge's
    weights e^(m_i - m) are 1 there and multiply l_i = 0 and acc_i = 0, so
    the row is 0 with no NaN, as in the Pallas kernel; the chunk form's
    rows too."""
    table = TABLE.copy()
    table[1] = -1
    for t in (1, 4):
        q, kp, vp, pos = _inputs(t)
        args = (torch.from_numpy(q), torch.from_numpy(kp),
                torch.from_numpy(vp), torch.from_numpy(table),
                torch.from_numpy(pos))
        out = tops.paged_attention_split_reference(*args, split_keys=4)
        assert torch.isfinite(out).all() and torch.all(out[1] == 0.0)
        np.testing.assert_allclose(
            out.numpy(), tops.paged_attention_reference(*args).numpy(),
            atol=1e-5)
        if t == 1:
            pallas = np.asarray(j_attend(
                jnp.asarray(q[:, 0]), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(table), jnp.asarray(pos), interpret=True))
            np.testing.assert_allclose(out[:, 0].numpy(), pallas, atol=1e-5)


def test_split_reference_chunk_form_matches_pallas():
    """The split merge over T = 4 queries per slot, spans of 3 pages: the
    Pallas chunk kernel in interpret mode within 1e-5 (f32)."""
    q, kp, vp, pos = _inputs(4)
    split = tops.paged_attention_split_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(TABLE), torch.from_numpy(pos), split_keys=12)
    pallas = np.asarray(j_attend_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(TABLE),
        jnp.asarray(pos), interpret=True))
    np.testing.assert_allclose(split.numpy(), pallas, atol=1e-5)


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_route_pins_the_instances_for_each_form(dtype, d):
    """Decode (T = 1) takes the split route at every dtype, int8 or not,
    windowed or not, when D is a multiple of 16; a chunk (T > 1) takes the
    tensor-core route only without a window over dense bf16/f16 pages at
    D 64 or 128; everything else takes SIMT."""
    q = torch.zeros((1, 1, 2, d), dtype=dtype)
    dense = torch.zeros((2, 4, 2, d), dtype=dtype)
    int8 = (torch.zeros((2, 4, 2, d), dtype=torch.int8),
            torch.zeros((2, 4, 2, 1)))
    for pages in (dense, int8):
        for window in (0, 8):
            assert tops._route(q, pages, 1, window) == (
                "split" if d % 16 == 0 else "simt")
            for t in (2, 37, 256):
                wgmma = (pages is dense and window == 0 and d in (64, 128)
                         and dtype != torch.float32)
                assert tops._route(q, pages, t, window) == (
                    "wgmma" if wgmma else "simt")


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    q, kp, vp, pos = _inputs(4)
    counters = ("launches", "split_launches", "combine_launches",
                "wgmma_launches")
    before = [getattr(tops.paged_attention, c) for c in counters]
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(TABLE), torch.from_numpy(pos))
    assert torch.equal(tops.paged_attention_chunk(*args),
                       tops.paged_attention_reference(*args))
    q1 = args[0][:, :1].contiguous()
    assert torch.equal(tops.paged_attention(q1[:, 0], *args[1:]),
                       tops.paged_attention_reference(q1, *args[1:])[:, 0])
    assert [getattr(tops.paged_attention, c) for c in counters] == before


def test_split_spans_come_from_the_table_width():
    """The split grid is sized from the table's width alone (so the host
    never reads pos): ceil(max_pages * ps / split_keys) spans."""
    table = torch.full((3, 128), -1, dtype=torch.int32)
    assert tops._n_splits(table, 16) == 2048 // tops._SPLIT_KEYS
    assert tops._n_splits(table[:, :1], 5) == 1
    assert tops._n_splits(table[:, :52], 5) == -(-260 // tops._SPLIT_KEYS)


def test_wrapper_rejects_inputs_the_kernel_does_not_take():
    q, kp, vp, pos = _inputs(1)
    args = [torch.from_numpy(q[:, 0]), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(TABLE),
            torch.from_numpy(pos)]
    bad_table = list(args)
    bad_table[3] = args[3].long()
    with pytest.raises(TypeError, match="table"):
        tops.paged_attention(*bad_table)
    bad_dtype = list(args)
    bad_dtype[1] = args[1].double()
    with pytest.raises(TypeError, match="dense pages"):
        tops.paged_attention(*bad_dtype)
    strided = list(args)
    strided[1] = torch.from_numpy(kp).transpose(0, 1).contiguous() \
        .transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tops.paged_attention(*strided)
    with pytest.raises(ValueError, match="H_kv"):
        tops.paged_attention(torch.zeros(3, 3, 8), *args[1:])
