"""What decides ``correct`` in a served cell: after the window, a sample
of the finished requests drawn from the seed, the one with the most served
tokens always in it, is run through the float32 reference (prompt and
served tokens as one sequence), and each served token's reference logit is
read against the reference's best at its position. The number compared is
the widest of those gaps; greedy decoding puts it at 0 where the two sides
agree on the top token.

The control (``control=True``) reads, at the same positions of the same
sequences, the gap of the token that the reference computed through fp8
operands puts first: what the reading would be had the program taken that
step down in precision. A mixture of experts also compares the tokens
clear of the router's near-ties alone (``readings``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import inputs
from portbench.reference import model as ref

MEDIAN_TOKENS = 32


def sample(done: List[tuple], seed: int,
           min_tokens: int, min_requests: int) -> List[int]:
    """Indices into *done* ((prompt, served tokens, ...)): the one with
    the most served tokens, then others in the seed's order until the
    sample holds *min_tokens* served tokens and *min_requests* requests."""
    if not done:
        return []
    first = max(range(len(done)), key=lambda i: (len(done[i][1]), -i))
    order = [i for i in inputs.rng(seed, "check").permutation(len(done))
             if i != first]
    pick, n = [first], len(done[first][1])
    for i in order:
        if n >= min_tokens and len(pick) >= min_requests:
            break
        pick.append(int(i))
        n += len(done[i][1])
    return pick


# reference routing margins at which a token counts as clear of the
# router's near-ties (calibration reads each; a cell names its own)
MARGINS = (2.0 ** -7, 2.0 ** -6, 2.0 ** -5, 2.0 ** -4, 2.0 ** -3)


def readings(m: dict, weights: Dict[str, torch.Tensor],
             seqs: List[Tuple[List[int], List[int], List[float]]],
             control: bool, device, program_sets=None, rids=None,
             margin: float = 0.0) -> Dict[str, float]:
    """The numbers read over the sampled sequences ((prompt, served
    tokens, the program's logprob of each)):

    - ``widest_gap``: the widest gap, over every served token, between the
      reference's best logit and the served token's;
    - ``logprob_err``: each request's median of |the program's logprob of
      a served token - the reference's|, and the third largest of those
      over the requests with ``MEDIAN_TOKENS`` served tokens or more (all of
      them where none has as many: a median of a handful is no statistic).
      It reads a fault or a loss of precision that reaches most tokens of
      three requests, and nothing narrower;
    - ``clear_gap`` and ``clear_lp_err``: the widest gap, and the largest
      |logprob error|, over the served tokens that are clear of the
      router's near-ties: those whose reference routing margin (the router
      logit of the last chosen expert less the best unchosen one's) is
      *margin* or more at every layer. In a mixture of experts a token
      whose margin is below what the program's bf16 router resolves may
      take the other expert there and move its logits by far more than
      rounding (``PERF.md``); a clear token seldom does, so one broken
      token or step among the clear ones reads in full. In a dense model
      every token is clear.

    With *control* the same numbers of the reference computed through fp8
    operands in the program's place, each under ``control_`` and its name
    (the gaps are those of the token it puts first, the logprob errors
    those of its logprob of the served token). ``by_margin`` gives, for
    each margin of ``MARGINS``, the share of tokens clear and the clear
    numbers of both (calibration). *program_sets* (``routes.Routes.sets``,
    with the *rids* of *seqs*) adds, for each served token whose program
    choice of experts differs from the reference's, the reference's least
    routing margin there and the token's gap (calibration only)."""
    ref.no_tf32()
    moe = bool(m.get("n_experts"))
    margins = sorted({float(margin), *(MARGINS if moe else ())})
    worst = worst_ctrl = 0.0
    n, flips, medians = 0, [], []
    # per margin: [clear tokens, gap, lp err, control gap, control lp err]
    clear = {t: [0, 0.0, 0.0, 0.0, 0.0] for t in margins}
    for j, (prompt, served, lps) in enumerate(seqs):
        seq = torch.tensor(prompt + served, device=device)
        rows = torch.arange(len(prompt) - 1, len(seq) - 1, device=device)
        routes = [] if moe else None
        lf = ref.logits(weights, m, seq, rows, routes=routes)
        best = lf.max(-1).values
        tok = torch.tensor(served, device=device)
        ar = torch.arange(len(served), device=device)
        gap = best - lf[ar, tok]
        worst = max(worst, float(gap.max()))
        lp_ref = torch.log_softmax(lf, -1)[ar, tok]
        err = (torch.tensor(lps, device=device) - lp_ref).abs()
        medians.append([len(served), float(err.median()), None])
        n += len(served)
        if moe:
            low = torch.stack([mg for _ix, mg in routes]).min(0).values
            low = low.to(device)[rows]
        else:
            low = torch.full((len(served),), float("inf"), device=device)
        if control:
            l8 = ref.logits(weights, m, seq, rows, "fp8")
            gap8 = best - lf[ar, l8.argmax(-1)]
            worst_ctrl = max(worst_ctrl, float(gap8.max()))
            e8 = (torch.log_softmax(l8, -1)[ar, tok] - lp_ref).abs()
            medians[-1][2] = float(e8.median())
            del l8
        for t, c in clear.items():
            ok = low >= t
            if not bool(ok.any()):
                continue
            c[0] += int(ok.sum())
            c[1] = max(c[1], float(gap[ok].max()))
            c[2] = max(c[2], float(err[ok].max()))
            if control:
                c[3] = max(c[3], float(gap8[ok].max()))
                c[4] = max(c[4], float(e8[ok].max()))
        if program_sets is not None and moe:
            gcpu = gap.cpu()
            for q, pos in enumerate(rows.tolist()):
                differ = [mg[pos] for layer, (ix, mg) in enumerate(routes)
                          if program_sets.get((rids[j], pos, layer))
                          not in (None, frozenset(ix[pos].tolist()))]
                if differ:
                    flips.append([float(min(differ)), float(gcpu[q])])
        del lf
    long = [r for r in medians if r[0] >= MEDIAN_TOKENS] or medians
    mine = clear[float(margin)]
    out = {"widest_gap": worst,
           "logprob_err": _third_largest([r[1] for r in long]),
           "clear_gap": mine[1], "clear_lp_err": mine[2],
           "clear_tokens": mine[0],
           "served_tokens": n, "requests": len(seqs),
           "per_request": medians,
           "by_margin": {repr(t): [c[0] / max(1, n)] + c[1:3]
                         + (c[3:] if control else [])
                         for t, c in clear.items()}}
    if control:
        out.update(control_widest_gap=worst_ctrl,
                   control_logprob_err=_third_largest([r[2] for r in long]),
                   control_clear_gap=mine[3], control_clear_lp_err=mine[4])
    if program_sets is not None:
        out["flips"] = flips
        out["flip_share"] = len(flips) / max(1, n)
    return out


def _third_largest(values) -> float:
    """The third largest value (the smallest of fewer)."""
    return sorted(values)[-min(3, len(values))] if values else 0.0


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (no interpolation: an infinite value, a
    request that never came, stays infinite)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return float("inf")
    return float(v[max(0, int(np.ceil(q / 100.0 * v.size)) - 1)])
