"""Prefill chunks over int8 page pools, on the shapes the tensor-core chunk
kernel's int8 instance takes (T > 1, D 64 or 128, no window): the port's
plain version (what the wrapper runs for CPU tensors) against the Pallas
chunk kernel in interpret mode and the JAX gather core, f32 within 1e-5;
and the int8 instance's order of arithmetic — the K scale applied to each
score column after q . k8, the V scale to each weight before P V, the
normaliser over the unscaled weights — against the same references, so
that the rearrangement is pinned where the CUDA kernel cannot run. The
kernel against the plain version on the card is in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.jobs import paged as jpaged
from kubetpu.jobs.quant import quantize_kv_chunk as j_quantize
from kubetpu.ops.paged_attention import paged_attention_chunk as j_attend_chunk
from kubetpu_torch.jobs import paged as tpaged
from kubetpu_torch.ops import paged_attention as tops

torch.set_num_threads(1)

H_KV = 2
SHARED = 3          # pages of the cached prefix both slots map


def _prefix_hit(t, g, ps, d, seed=0):
    """Two slots at a prefix hit: both tables lead with the same SHARED
    physical pages, then each slot's own pages for its T-token chunk at
    pos = SHARED * ps, then an unmapped tail entry; slot 1's second shared
    page is unmapped (a hole inside its visible range). Returns numpy q
    (2, T, H, D), the JAX int8 pools, the torch pools (the same bytes),
    the table and pos."""
    rng = np.random.default_rng(seed)
    own = -(-t // ps)
    n_pool = SHARED + 2 * own + 1
    perm = rng.permutation(n_pool).astype(np.int32)
    table = np.full((2, SHARED + own + 1), -1, np.int32)
    for i in range(2):
        table[i, :SHARED] = perm[:SHARED]
        table[i, SHARED:SHARED + own] = perm[SHARED + i * own:
                                             SHARED + (i + 1) * own]
    table[1, 1] = -1
    pos = np.full((2,), SHARED * ps, np.int32)
    q = rng.standard_normal((2, t, H_KV * g, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pool, ps, H_KV, d)).astype(np.float32)
              for _ in range(2))
    jk, jv = j_quantize(jnp.asarray(kp)), j_quantize(jnp.asarray(vp))
    tk = tuple(torch.from_numpy(np.array(x)) for x in jk)
    tv = tuple(torch.from_numpy(np.array(x)) for x in jv)
    return q, (jk, jv), (tk, tv), table, pos


def _references(q, jk, jv, table, pos):
    """(Pallas chunk kernel in interpret mode, JAX gather core) outputs."""
    jq, jt, jpos = jnp.asarray(q), jnp.asarray(table), jnp.asarray(pos)
    pallas = np.asarray(j_attend_chunk(jq, jk, jv, jt, jpos, interpret=True))
    gather = np.asarray(jpaged._attend_paged_chunk(jq, jk, jv, jt, jpos))
    return pallas, gather


def _scales_on_fragments(q, tk, tv, table, pos):
    """The int8 instance's arithmetic in f32 numpy: scores (q . k8) s_k
    scaled by D^-1/2, masked (unmapped pages, keys past each query's
    position), weights p = exp(s - max), l = sum p, out = sum (p s_v) v8 /
    max(l, 1e-30); a row that sees no key is 0."""
    b, t, h, d = q.shape
    (k8, ks), (v8, vs) = (tuple(x.numpy() for x in pair) for pair in (tk, tv))
    ps, h_kv = k8.shape[1], k8.shape[2]
    g = h // h_kv
    safe = np.maximum(table, 0)
    n_keys = table.shape[1] * ps

    def rows(x):                               # (B, S, H_kv, ...)
        return x[safe].reshape(b, n_keys, h_kv, -1)

    k, sk, v, sv = rows(k8).astype(np.float32), rows(ks), rows(v8), rows(vs)
    qg = q.reshape(b, t, h_kv, g, d)
    s = np.einsum("btkgd,bskd->bkgts", qg, k)
    s = s * sk[..., 0].transpose(0, 2, 1)[:, :, None, None, :]
    s = s * np.float32(d ** -0.5)
    q_pos = pos[:, None] + np.arange(t)
    vis = (np.arange(n_keys)[None, None, :] <= q_pos[:, :, None]) \
        & np.repeat(table >= 0, ps, axis=1)[:, None, :]        # (B, T, S)
    vis = vis[:, None, None]
    s = np.where(vis, s, np.float32(-1e30))
    m = s.max(axis=-1, keepdims=True)
    p = np.where(vis, np.exp(s - m), np.float32(0))
    l = p.sum(axis=-1, keepdims=True)
    pv = p * sv[..., 0].transpose(0, 2, 1)[:, :, None, None, :]
    o = np.einsum("bkgts,bskd->bkgtd", pv, v.astype(np.float32))
    o = o / np.maximum(l, np.float32(1e-30))
    return o.transpose(0, 3, 1, 2, 4).reshape(b, t, h, d)


@pytest.mark.parametrize("t", [2, 9, 64])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("ps,d", [(12, 64), (16, 128)], ids=["ps12_d64",
                                                             "ps16_d128"])
def test_int8_chunk_at_a_prefix_hit_matches_pallas_and_gather_core(t, g, ps,
                                                                   d):
    q, (jk, jv), (tk, tv), table, pos = _prefix_hit(t, g, ps, d)
    pallas, gather = _references(q, jk, jv, table, pos)
    args = (torch.from_numpy(table), torch.from_numpy(pos))
    out = tops.paged_attention_chunk(torch.from_numpy(q), tk, tv,
                                     *args).numpy()
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(out, gather, atol=1e-5)
    tg = tpaged._attend_paged_chunk(torch.from_numpy(q), tk, tv,
                                    *args).numpy()
    np.testing.assert_allclose(tg, gather, atol=1e-5)
    # both slots read the shared rows; slot 1 skips its hole
    assert not np.allclose(out[0], out[1], atol=1e-3)


@pytest.mark.parametrize("t", [2, 9, 64])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("ps,d", [(12, 64), (16, 128)], ids=["ps12_d64",
                                                             "ps16_d128"])
def test_scales_on_the_fragments_match_dequantized_pages(t, g, ps, d):
    """(q . k8) s_k and (p s_v) . v8 with l over the unscaled p, as the
    int8 instance computes them, equal attention over the dequantized
    pages (the Pallas kernel and the plain version) in f32 within 1e-5:
    the two orders differ in summation order only."""
    q, (jk, jv), (tk, tv), table, pos = _prefix_hit(t, g, ps, d, seed=1)
    folded = _scales_on_fragments(q, tk, tv, table, pos)
    pallas, _ = _references(q, jk, jv, table, pos)
    np.testing.assert_allclose(folded, pallas, atol=1e-5)
    plain = tops.paged_attention_chunk(torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(table),
                                       torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(folded, plain, atol=1e-5)


def test_int8_chunk_of_an_unmapped_slot_is_zero():
    """A slot whose table is all -1 sees no key: 0 from the plain version,
    the fragment-scaled order and the Pallas kernel alike."""
    q, (jk, jv), (tk, tv), table, pos = _prefix_hit(9, 4, 12, 64, seed=2)
    table[1] = -1
    pallas, _ = _references(q, jk, jv, table, pos)
    out = tops.paged_attention_chunk(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(pos)).numpy()
    folded = _scales_on_fragments(q, tk, tv, table, pos)
    for x in (out, folded, pallas):
        assert np.all(x[1] == 0.0) and np.isfinite(x).all()
    np.testing.assert_allclose(out, pallas, atol=1e-5)
    np.testing.assert_allclose(folded, pallas, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_int8_chunks_route_to_the_tensor_core_kernel(dtype, d):
    """An int8-pool chunk at bf16/f16 q and D 64/128 without a window
    takes the wgmma route (its int8 instance); on CPU tensors the wrapper
    still runs the plain version and counts no launch."""
    q, _, (tk, tv), table, pos = _prefix_hit(9, 2, 16, d)
    tq = torch.from_numpy(q).to(dtype)
    assert tops._route(tq, tk, 9, 0) == "wgmma"
    assert tops._route(tq, tk, 9, 8) == "simt"
    assert tops._route(tq.float(), tk, 9, 0) == "simt"
    counters = ("launches", "wgmma_launches", "wgmma_int8_launches",
                "simt_launches")
    before = [getattr(tops.paged_attention, c) for c in counters]
    args = (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(pos))
    assert torch.equal(tops.paged_attention_chunk(*args),
                       tops.paged_attention_reference(*args))
    assert [getattr(tops.paged_attention, c) for c in counters] == before
