"""The control at a size the CPU holds: the reference through fp8 operands
in the program's place reads at least three times what the program (bf16,
as the cells run it) reads, on three seeds, in the number each cell
compares, so that a limit between the two readings exists. On the card the
same control is read at each cell's own size (``--control 1``; the
readings and the limits are in ``PERF.md``)."""

from __future__ import annotations

import pytest
import torch

from kubetpu_torch.jobs.paged import PagedDecodeServer
from portbench import build, check, inputs, serve
from portbench.gen import Request
from conftest import tiny_cell


def _served(cell, seed, out_len):
    """Four requests of *out_len* tokens through the cell's server on the
    CPU -> (prompt, served tokens, logprobs) each."""
    m, s = cell.config["model"], cell.traffic["server"]
    cpu = torch.device("cpu")
    w = inputs.make_weights(m, seed, cpu, torch.bfloat16)
    cfg = build.model_config(m)
    server = PagedDecodeServer(
        cfg, build.transformer(cfg, w), n_slots=4, max_seq=96,
        max_new_tokens=out_len, page_size=16, n_pages=48,
        prefill_budget=32, overlap=True, device=cpu)
    drv = serve.Driver(server)
    for i in range(4):
        prompt = inputs.tokens(seed, f"p{i}", 24 + 4 * i, m["vocab"])
        drv.send(Request(0.0, prompt.tolist(), out_len, True), 0.0)
    while drv.runnable():
        drv.step_once()
    drv.close()
    return w, [(x.req.prompt, x.tokens, x.logprobs)
               for x in drv.rec.served.values()]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", ["mistral-7b-v0.2.code",
                                      "mixtral-8x7b-l16.batch"])
def test_control_reads_three_times_the_program(workload, seed):
    cell = tiny_cell(workload)
    w, seqs = _served(cell, seed, check.MEDIAN_TOKENS + 8)
    r = check.readings(cell.config["model"], w, seqs, True,
                       torch.device("cpu"),
                       margin=cell.traffic["check"].get("route_margin", 0.0))
    for number in cell.limits:
        assert r["control_" + number] >= 3 * r[number], (number, r)
