"""The yardstick's operation and byte counts against hand counts at small
shapes."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import roofline

M = dict(vocab=10, d_model=4, n_layers=2, n_heads=2, n_kv_heads=1,
         head_dim=2, d_ff=8)


def test_matmul_params_dense_and_moe():
    # attention 4*2*2 + 2*4*1*2 + 2*2*4 = 48, MLP 3*4*8 = 96, head 40
    assert roofline.matmul_params(M) == 2 * (48 + 96) + 40
    moe = dict(M, n_experts=4, moe_top_k=2)
    # router 4*4 = 16 and two experts of 96
    assert roofline.matmul_params(moe) == 2 * (48 + 16 + 192) + 40


def test_chunk_keys_and_work():
    assert roofline.chunk_keys(0, 3) == 1 + 2 + 3
    assert roofline.chunk_keys(5, 2) == 6 + 7
    step = SimpleNamespace(chunks=[(5, 2)], decode_ctx=[3, 4])
    p = 2 * roofline.matmul_params(M)
    a = 4 * 2 * 2 * 2            # 4 * layers * heads * head_dim
    assert roofline.work_flops(M, [step]) == p * 4 + a * (13 + 3 + 4)


def test_paged_attention_least_time():
    kv_row, q_row = 2 * 1 * 2 * 2, 2 * 2 * 2 * 2
    step = SimpleNamespace(chunks=[(5, 2)], decode_ctx=[3, 4])
    want = 2 * (roofline.least_s(4 * 2 * 2 * 13, 7 * kv_row + 2 * q_row)
                + roofline.least_s(4 * 2 * 2 * 7, 7 * kv_row + 2 * q_row))
    assert roofline.paged_attn_least_s(M, [step]) == pytest.approx(want)


def test_moe_expert_least_time():
    moe = dict(M, n_experts=4, moe_top_k=2)
    step = SimpleNamespace(chunks=[(0, 1), (0, 3)], decode_ctx=[9])
    assert roofline.moe_calls([step]) == [1, 3, 1]
    # one row reaches 2 experts, three rows all 4
    def call(n, used):
        return roofline.least_s(2 * 3 * 4 * 8 * 2 * n,
                                3 * used * 4 * 8 * 2 + 2 * 2 * n * 4 * 2)
    want = 2 * (call(1, 2) + call(3, 4) + call(1, 2))
    assert roofline.moe_expert_least_s(moe, [step]) == pytest.approx(want)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(roofline.BF16_FLOP_S, 0) == 1.0
    assert roofline.least_s(0, roofline.HBM_BYTES_S) == 1.0


def test_strata_keep_the_lengths_and_spread_every_block():
    from portbench import gen, inputs

    d = dict(dist="lognormal", median=16, sigma=1.2, min=4, max=512)
    a = gen.lengths(d, 64, inputs.rng(1, "t"), 16)
    b = gen.lengths(d, 64, inputs.rng(2, "t"), 16)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert sorted(a) == sorted(gen.lengths(d, 64, inputs.rng(3, "t")))
    edges = sorted(a)[::4]                       # each stratum's least
    for blk in a.reshape(4, 16):
        ranks = sorted(int(np.searchsorted(edges, x, side="right")) - 1
                       for x in blk)
        assert ranks == list(range(16)) or len(set(blk)) < 16


def test_expert_shapes_keep_only_the_expert_products():
    from portbench.trace import expert_shapes

    keep = expert_shapes(dict(n_experts=8, d_model=64, d_ff=128))
    assert keep([[8, 5, 64], [8, 64, 128]])          # gate, up
    assert keep([[8, 5, 128], [8, 128, 64]])         # down
    assert not keep([[1, 5, 64], [1, 64, 128]])      # einsum projection
    assert not keep([[8, 5, 64], [8, 64, 32]])
    assert not expert_shapes(dict(d_model=64, d_ff=128))(
        [[8, 5, 64], [8, 64, 128]])
