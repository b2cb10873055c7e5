"""Shared pieces of the benchmark's own tests: a cell of ``BENCHMARK.json``
cut to a size the CPU runs in seconds (the same harness, the same
program, on ``device="cpu"``)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(vocab=256, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, max_seq=512)


def tiny_cell(workload: str, limit: float = 0.5, dtype: str = "bfloat16"):
    """*workload*'s cell at a tiny width and load, on the CPU."""
    from portbench import run

    c = copy.deepcopy(run.load_cell(workload))
    c.config["model"].update(TINY_MODEL, dtype=dtype)
    t = c.traffic
    for key, lo, hi, med in (("prompt", 16, 40, 32), ("output", 3, 12, 6)):
        t[key].update(min=lo, max=hi)
        if t[key]["dist"] == "lognormal":
            t[key]["median"] = med
    t["server"].update(n_slots=4, max_seq=96, max_new_tokens=12,
                       n_pages=48, prefill_budget=32)
    t.update(clients=4, max_refills_per_s=400, preroll_s=0.0)
    c.limits = {name: limit for name in c.limits}
    return c


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
