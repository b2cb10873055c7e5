"""Rehearsal of the mixture-of-experts comparison on the CPU, at the
published widths of ``configs/mixtral-8x7b-l16.json`` with fewer layers
and a small batch: the port's ``PagedDecodeServer`` (chunked prefill and
paged decode through ``_moe_mlp_capacity``, dropless at capacity factor
8) against the float32 reference, seed by seed.

Each served token's gap (the reference's best logit less the served
token's) is split by whether some layer's top-2 expert set at the token's
own position differs between the program (recorded inside the served
forward) and the reference. The fp8 control's gaps are read at the same
positions.

    python3 -m portbench.rehearse_moe --layers 2 --seeds 493138518,1,2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import build, inputs, serve
from portbench.routes import Routes
from portbench.gen import Request
from portbench.reference import model as ref

CONFIG = Path(__file__).resolve().parent / "configs" / "mixtral-8x7b-l16.json"


def one_seed(m: dict, seed: int, slots: int, prompt: tuple, out_len: int
             ) -> dict:
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cpu = torch.device("cpu")
    weights = inputs.make_weights(m, seed, cpu)
    cfg = build.model_config(m)
    server = PagedDecodeServer(
        cfg, build.transformer(cfg, weights), n_slots=slots, max_seq=256,
        max_new_tokens=out_len, page_size=16, n_pages=16 * slots,
        prefill_budget=64, overlap=True, device=cpu)
    routes = Routes(server, model_lib)
    try:
        r = inputs.rng(seed, "rehearsal")
        lens = r.integers(prompt[0], prompt[1] + 1, size=slots)
        reqs = [Request(0.0, inputs.tokens(seed, f"r{i}", int(n), m["vocab"])
                        .tolist(), out_len, True) for i, n in enumerate(lens)]
        drv = serve.Driver(server)
        for q in reqs:
            drv.send(q, 0.0)
        while drv.runnable():
            drv.step_once()
        drv.close()
    finally:
        routes.close()
    ref.no_tf32()
    gaps = {"flip": [], "same": []}
    ctrl, margins, least = [], [], []
    for s in drv.rec.served.values():
        seq = torch.tensor(s.req.prompt + s.tokens)
        p = len(s.req.prompt)
        rows = torch.arange(p - 1, len(seq) - 1)
        ref_routes = []
        lf = ref.logits(weights, m, seq, rows, routes=ref_routes)
        l8 = ref.logits(weights, m, seq, rows, "fp8")
        best = lf.max(-1).values
        ar = torch.arange(len(s.tokens))
        g = (best - lf[ar, torch.tensor(s.tokens)]).numpy()
        ctrl += (best - lf[ar, l8.argmax(-1)]).tolist()
        for j, pos in enumerate(rows.tolist()):
            differ = [float(mg[pos]) for layer, (ix, mg) in
                      enumerate(ref_routes)
                      if routes.sets.get((s.rid, pos, layer))
                      != frozenset(ix[pos].tolist())]
            gaps["flip" if differ else "same"].append(float(g[j]))
            margins += [min(differ)] if differ else []
            least.append(min(float(mg[pos]) for _ix, mg in ref_routes))
    # the reference's least routing margin at the flips, and the share of
    # served tokens whose least margin lies under each threshold
    out = {"seed": seed, "control_widest": max(ctrl),
           "flip_margins": margins,
           "share_under": {str(t): float(np.mean(np.asarray(least) < t))
                           for t in (0.01, 0.02, 0.05, 0.1)}}
    for k, v in gaps.items():
        out[k] = {"tokens": len(v), "widest": max(v, default=0.0),
                  "mean": float(np.mean(v)) if v else 0.0,
                  "nonzero": int(np.count_nonzero(v))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.rehearse_moe")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt", default="48,96")
    ap.add_argument("--out-len", type=int, default=24)
    a = ap.parse_args(argv)
    m = dict(json.loads(CONFIG.read_text())["model"], n_layers=a.layers)
    lo, hi = (int(x) for x in a.prompt.split(","))
    for seed in (int(x) for x in a.seeds.split(",")):
        print(json.dumps(one_seed(m, seed, a.slots, (lo, hi), a.out_len)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
