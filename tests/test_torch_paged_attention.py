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
