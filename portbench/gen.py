"""The one traffic generator: it reads a mix's data file
(``traffic/<name>.json``) and makes its requests from the seed.

Every seed gets the same work in another order. Lengths are the quantiles
``(i + 0.5) / n`` of the mix's distributions, and arrival gaps the same
quantiles of the exponential, each set shuffled by the seed; only the
order, the pairing and the token ids change with the seed. With
``"strata": k`` in the mix, lengths are shuffled in blocks: each run of k
consecutive requests holds one length from each of the k equal strata of
the sorted quantiles, so that any stretch of the order, such as the part
of a growing queue that a window serves, holds nearly the same lengths
whatever the seed. An open loop's window holds exactly ``rate * seconds``
arrivals, its gaps scaled to fill the window.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from portbench import inputs


@dataclasses.dataclass
class Request:
    due: float              # seconds from the window's start (open loop)
    prompt: List[int]
    out_len: int            # tokens the client reads before it stops
    in_window: bool


def _ppf(dist: dict, u: np.ndarray) -> np.ndarray:
    """Inverse CDF of a length distribution at *u*, rounded and clipped
    to its [min, max]."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo + 1)
    elif dist["dist"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def lengths(dist: dict, n: int, r: np.random.Generator, strata: int = 1
            ) -> np.ndarray:
    """*n* lengths: the distribution's n quantiles in the seed's order,
    one from each of *strata* strata in every block of that many."""
    k = max(1, min(strata, n))
    m = -(-n // k)                              # blocks
    u = (np.arange(m * k) + 0.5) / (m * k)
    v = np.sort(_ppf(dist, u)).reshape(k, m)    # row s: stratum s
    v = np.stack([r.permutation(row) for row in v])   # column b: block b
    blocks = [r.permutation(v[:, b]) for b in range(m)]
    return np.concatenate(blocks)[:n]


def gaps(n: int, r: np.random.Generator) -> np.ndarray:
    """*n* exponential gaps of mean 1: its n quantiles, shuffled."""
    u = (np.arange(n) + 0.5) / n
    return r.permutation(-np.log1p(-u))


def _requests(mix: dict, seed: int, block: str, n: int, vocab: int,
              extra_prompt: int = 0) -> List[Request]:
    r = inputs.rng(seed, f"{block}.lengths")
    k = mix.get("strata", 1)
    p_len = lengths(mix["prompt"], n, r, k)
    o_len = lengths(mix["output"], n, r, k)
    pre = np.zeros(n, np.int64)
    if extra_prompt:
        # a closed loop's first wave, met mid-flight: each sequence has
        # already produced a share of its output, read as prompt
        pre = np.floor(r.permutation((np.arange(n) + 0.5) / n)
                       * o_len).astype(np.int64)
    ids = inputs.tokens(seed, f"{block}.tokens", int((p_len + pre).sum()),
                        vocab)
    out, at = [], 0
    for p, o, k in zip(p_len, o_len, pre):
        out.append(Request(0.0, ids[at:at + p + k].tolist(), int(o - k),
                           block == "window"))
        at += p + k
    return out


def open_loop(mix: dict, seed: int, seconds: float, vocab: int
              ) -> List[Request]:
    """Pre-roll arrivals over ``mix["preroll_s"]`` before the window, then
    ``rate * seconds`` arrivals in the window, in order of due time."""
    rate = mix["rate_per_s"]
    reqs = []
    for block, span, t0 in (("preroll", mix["preroll_s"], -mix["preroll_s"]),
                            ("window", seconds, 0.0)):
        n = max(1, int(round(rate * span)))
        g = gaps(n, inputs.rng(seed, f"{block}.gaps"))
        due = t0 + np.cumsum(g) * (span / g.sum()) - g[0] * span / g.sum()
        block_reqs = _requests(mix, seed, block, n, vocab)
        for req, t in zip(block_reqs, due):
            req.due = float(t)
        reqs += block_reqs
    return reqs


def closed_loop(mix: dict, seed: int, seconds: float, vocab: int
                ) -> List[Request]:
    """The first wave of ``mix["clients"]`` sequences (met mid-flight when
    ``mix["steady_start"]``), then refills in order, enough for the
    window at ``mix["max_refills_per_s"]``."""
    c = mix["clients"]
    first = _requests(mix, seed, "preroll", c, vocab,
                      extra_prompt=int(bool(mix.get("steady_start"))))
    n = max(1, int(math.ceil(mix["max_refills_per_s"] * seconds)))
    return first + _requests(mix, seed, "window", n, vocab)
