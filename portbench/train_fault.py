"""The fault that keeps the training cell out of ``BENCHMARK.json``: the
port's bf16 AdamW step leaves the RMSNorm gains unmoved while every matrix
moves (a float32 step moves each gain by about lr an element and step).

At the cell's size (Mistral-7B's widths, 8 layers, batch 8 x 4096, full
remat, flash attention, loss chunks of 512), per seed: the loss of eight
steps, each step's seconds, and after the third step the largest change of
a norm gain and the smallest and median change of the other leaves.

    python3 -m portbench.train_fault 3201,3202,3203
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from portbench import build, inputs

CONFIG = Path(__file__).resolve().parent / "configs" / "mistral-7b-v0.2.json"


def one_seed(m: dict, seed: int) -> dict:
    from kubetpu_torch.jobs import train

    torch.cuda.reset_peak_memory_stats()
    w = inputs.make_weights(m, seed, "cuda")
    cfg = dataclasses.replace(build.model_config(m), remat=True,
                              loss_chunk=512, max_seq=4096)
    model = build.transformer(cfg, w)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = train.make_optimizer()
    state = train.state_from_params(model, opt)
    step = train.make_train_step(cfg, opt, attention="flash")
    toks = torch.tensor(inputs.tokens(seed, "train", 8 * 4097, m["vocab"])
                        .reshape(8, 4097), device="cuda")
    losses, times = [], []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, toks[:, :-1], toks[:, 1:])
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i == 2:
            change = {n: float((p.detach().float() - p0[n].float()).norm())
                      for n, p in state.params.named_parameters()}
    norms = [v for n, v in change.items() if n.split(".")[-1].startswith("ln")]
    mats = sorted(v for n, v in change.items()
                  if not n.split(".")[-1].startswith("ln"))
    return {"seed": seed, "losses": losses, "step_s": times,
            "tokens_per_s_steps_4_8": 8 * 4096 * 5 / sum(times[3:]),
            "norm_change_max": max(norms), "norm_leaves": len(norms),
            "matrix_change_min": mats[0],
            "matrix_change_median": mats[len(mats) // 2],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main(argv=None) -> int:
    seeds = [int(x) for x in (argv or sys.argv[1:])[0].split(",")]
    m = dict(json.loads(CONFIG.read_text())["model"], n_layers=8)
    for seed in seeds:
        print(json.dumps(one_seed(m, seed)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
