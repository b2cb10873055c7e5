"""The inputs both sides are handed: weights and tokens made from the seed.

Weights are drawn on the device in a few large calls into one flat buffer
per run, in the layouts of ``kubetpu_torch.jobs.model`` (``wq (d, H, hd)``,
``wo (H, hd, d)``, ``w_gate (E, d, f)``, ``head (d, V)``; documented here so
that the reference needs nothing of the program) and scaled by the usual
init rule: normal draws times ``d**-0.5`` (``(H*hd)**-0.5`` for ``wo``,
``d_ff**-0.5`` for ``w_down``), norm gains at 1. The same seed gives the same
bytes, so the reference draws them again after the program is freed.
This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# elements drawn per call: a few calls fill a 47 GB model
_DRAW = 1 << 30


def weight_plan(m: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf for model sizes *m* (the
    ``model`` block of a configuration file); scale 0 marks a norm gain
    (ones)."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    f, v, e = m["d_ff"], m["vocab"], m.get("n_experts", 0)
    s = d ** -0.5
    ex = (e,) if e else ()
    plan = [("embed", (v, d), s)]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}."
        plan += [(b + "ln1", (d,), 0.0), (b + "ln2", (d,), 0.0),
                 (b + "wq", (d, h, hd), s), (b + "wk", (d, kv, hd), s),
                 (b + "wv", (d, kv, hd), s), (b + "wo", (h, hd, d),
                                               (h * hd) ** -0.5),
                 (b + "w_gate", ex + (d, f), s), (b + "w_up", ex + (d, f), s),
                 (b + "w_down", ex + (f, d), f ** -0.5)]
        if e:
            plan.append((b + "moe_router", (d, e), s))
    plan += [("ln_f", (d,), 0.0), ("head", (d, v), s)]
    return plan


def n_elements(m: dict) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in weight_plan(m))


def make_weights(m: dict, seed: int, device, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of *m* as a view into one buffer drawn from *seed* on
    *device* (``torch.Generator`` there), in *dtype*."""
    plan = weight_plan(m)
    total = sum(int(np.prod(shape)) for _, shape, _ in plan)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, _DRAW):
        flat[i:i + _DRAW].normal_(generator=gen)
    out, at = {}, 0
    for name, shape, scale in plan:
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        at += n
        if scale:
            leaf.mul_(scale)
        else:
            leaf.fill_(1.0)
        out[name] = leaf
    return out


def rng(seed: int, stream: str) -> np.random.Generator:
    """The host generator of one named stream of *seed* (traffic, tokens,
    the sample that is checked): streams never share draws."""
    key = int.from_bytes(stream.encode(), "little") % (1 << 63)
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), key])


def tokens(seed: int, stream: str, n: int, vocab: int) -> np.ndarray:
    """*n* token ids uniform over the vocabulary."""
    return rng(seed, stream).integers(0, vocab, size=n, dtype=np.int64)
