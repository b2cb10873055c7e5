"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a served
cell can have, and true without one. The cells run in float32 here, so a
sound run reads rounding alone and the limit can sit far below any fault.
(The exchange between chips does not exist on these one-card cells.)"""

from __future__ import annotations

import pytest
import torch

from kubetpu_torch.jobs.paged import PagedDecodeServer
from portbench import run
from conftest import tiny_cell

CELLS = ["mistral-7b-v0.2.code", "mixtral-8x7b-l16.batch"]
LIMIT = 1e-3


def _altered_token(monkeypatch, vocab):
    step = PagedDecodeServer._device_step

    def altered(self):
        nxt, lp = step(self)
        return (nxt + 1) % vocab, lp

    monkeypatch.setattr(PagedDecodeServer, "_device_step", altered)


def _state_unchanged(monkeypatch, vocab):
    def unchanged(self):
        return self.last.clone(), torch.zeros(self.n_slots,
                                              device=self.last.device)

    monkeypatch.setattr(PagedDecodeServer, "_device_step", unchanged)


def _half_batch(monkeypatch, vocab):
    leg = PagedDecodeServer._step_leg

    def half(*args, **kwargs):
        logits = leg(*args, **kwargs)
        odd = logits[1::2]
        odd.copy_(logits[0::2][:odd.shape[0]])    # odd rows never computed
        return logits

    monkeypatch.setattr(PagedDecodeServer, "_step_leg", staticmethod(half))


def _one_step_altered(monkeypatch, vocab):
    """Every slot's token altered in one decode step of the run (the first
    from the ``ONE_STEP``-th on with every slot busy), the rest sound: a
    fault that a median over a request's tokens steps over."""
    step = PagedDecodeServer._device_step
    calls = [0, False]

    def once(self):
        nxt, lp = step(self)
        calls[0] += 1
        if calls[0] >= ONE_STEP and not calls[1] and self.active.all():
            calls[1] = True
            return (nxt + 1) % vocab, lp
        return nxt, lp

    monkeypatch.setattr(PagedDecodeServer, "_device_step", once)


ONE_STEP = 20
FAULTS = {"altered_token": _altered_token,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch,
          "one_step_altered": _one_step_altered}


def _run(workload, seed=11, every_request=False):
    cell = tiny_cell(workload, limit=LIMIT, dtype="float32")
    if every_request:
        # a request here lives a few steps, so one step's fault reaches a
        # few of them: compare every finished request, not a sample
        cell.traffic["check"]["min_tokens"] = 10 ** 9
    return run.run_served(cell, seed, 1.0, False, torch.device("cpu"))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["readings"]["served_tokens"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch, 256)
    res = _run(workload, every_request=fault == "one_step_altered")
    assert not res["correct"], res["checks"]
    compared = [c["value"] for k, c in res["checks"].items()
                if k != "unfinished"]
    assert max(compared) > 100 * LIMIT


def test_open_loop_mix_runs():
    """A mix of kind ``open_loop`` below the knee (Poisson arrivals at a
    fixed rate, timed from when each request was due, every request due
    in the window awaited) runs and checks, and a closed loop does too: a
    later cell can bring either as a data file."""
    cell = tiny_cell(CELLS[0], limit=LIMIT, dtype="float32")
    cell.traffic.update(kind="open_loop", rate_per_s=6.0, preroll_s=0.5,
                        saturate=False)
    res = run.run_served(cell, 5, 1.0, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert res["attempted"] == 6 and res["failed"] == 0
    assert res["checks"]["unfinished"]["value"] == 0
    cell.traffic.update(kind="closed_loop", clients=4)
    res = run.run_served(cell, 5, 1.0, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert "unfinished" not in res["checks"]


def test_above_the_knee_unfinished_is_not_failed():
    """An open loop above what the server completes ends at the close: the
    requests still queued then are attempted and not failed, and the run
    checks the ones it finished."""
    cell = tiny_cell(CELLS[0], limit=LIMIT, dtype="float32")
    cell.traffic.update(kind="open_loop", rate_per_s=400.0, saturate=True)
    res = run.run_served(cell, 7, 1.0, False, torch.device("cpu"))
    assert res["attempted"] == 400 and res["failed"] == 0
    assert res["readings"]["requests"] < 400
    assert res["correct"], res["checks"]


def test_control_in_the_programs_place_is_not_correct():
    """``--control 1`` holds the fp8 control's readings to the cell's own
    limits: at a limit between the two sides' readings the run comes out
    not correct (the cells' limits and readings at their own sizes are in
    ``PERF.md``)."""
    cell = tiny_cell(CELLS[0], limit=LIMIT, dtype="float32")
    res = run.run_served(cell, 11, 1.0, False, torch.device("cpu"),
                         control=True)
    assert not res["correct"], res["checks"]
    assert res["checks"]["widest_gap"]["value"] == \
        res["readings"]["control_widest_gap"]
