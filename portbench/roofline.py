"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes that the work of a window needs, counted from the
benchmark's own record of each step (prompt tokens of each prefill chunk
with its start, the context length of each decode row). Padding and rows
of empty slots are never counted; each input byte is counted once.

Peaks and the least-time rule are those of ``chip_smoke.py``
(``HBM_BYTES_S``, ``BF16_FLOP_S``, ``_bytes_bound``): NVIDIA's data sheet
for the H100 SXM, dense rates.
"""

from __future__ import annotations

from typing import Iterable, List

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate
BF16 = 2                       # bytes an element of the served dtype


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    return max(flops / BF16_FLOP_S, nbytes / HBM_BYTES_S)


def matmul_params(m: dict) -> int:
    """Parameters a token multiplies by in one forward: every block's
    projections, its MLP (the router and ``moe_top_k`` experts of a
    mixture), and the head; the embedding is a lookup."""
    d, h, kv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    e = m.get("n_experts", 0)
    mlp = d * e + m["moe_top_k"] * 3 * d * f if e else 3 * d * f
    return m["n_layers"] * (attn + mlp) + d * m["vocab"]


def token_flops(m: dict, ctx: int) -> float:
    """Forward operations of one token that attends *ctx* keys: 2 per
    multiply-add of every weight it meets, 4 * H * hd per key and layer
    (scores and values)."""
    return (2 * matmul_params(m)
            + 4 * m["n_layers"] * m["n_heads"] * m["head_dim"] * ctx)


def chunk_keys(start: int, t: int) -> int:
    """Keys the t queries of a causal chunk at *start* attend, summed."""
    return t * start + t * (t + 1) // 2


def work_flops(m: dict, steps: Iterable) -> float:
    """Forward operations of every prompt token and decode row of
    *steps*."""
    total = 0.0
    p = 2 * matmul_params(m)
    a = 4 * m["n_layers"] * m["n_heads"] * m["head_dim"]
    for st in steps:
        for start, t in st.chunks:
            total += p * t + a * chunk_keys(start, t)
        for ctx in st.decode_ctx:
            total += p + a * ctx
    return total


def paged_attn_least_s(m: dict, steps: Iterable) -> float:
    """Least time of the paged-attention calls of *steps*, each layer's
    call bound on its own: a decode step's rows as one call, each prefill
    chunk as one. Bytes: the visible K/V rows once, q read and the output
    written; operations 4 * hd per query head and visible key."""
    L, h, kv, hd = m["n_layers"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    kv_row = 2 * kv * hd * BF16            # a position's K and V, a layer
    q_row = 2 * h * hd * BF16              # a query read and its output
    total = 0.0
    for st in steps:
        for start, t in st.chunks:
            total += L * least_s(4 * h * hd * chunk_keys(start, t),
                                 (start + t) * kv_row + t * q_row)
        if st.decode_ctx:
            ctx = sum(st.decode_ctx)
            total += L * least_s(4 * h * hd * ctx,
                                 ctx * kv_row + len(st.decode_ctx) * q_row)
    return total


def moe_calls(steps: Iterable) -> List[int]:
    """The routed rows of every forward of *steps*: one per prefill chunk,
    one per decode step."""
    calls = []
    for st in steps:
        calls += [t for _start, t in st.chunks]
        if st.decode_ctx:
            calls.append(len(st.decode_ctx))
    return calls


def moe_expert_least_s(m: dict, steps: Iterable) -> float:
    """Least time of the expert products (gate, up, down) of every forward
    of *steps*: each routed choice's three products, and the weights of
    the experts the call can reach read once a layer."""
    d, f, e, k, L = (m["d_model"], m["d_ff"], m["n_experts"], m["moe_top_k"],
                     m["n_layers"])
    total = 0.0
    for n in moe_calls(steps):
        flops = 2 * 3 * d * f * k * n
        nbytes = 3 * min(e, k * n) * d * f * BF16 + 2 * k * n * d * BF16
        total += L * least_s(flops, nbytes)
    return total
