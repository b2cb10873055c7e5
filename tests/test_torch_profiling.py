"""The port's jobs profiling against ``kubetpu.jobs.profiling``:
``StepTimer.summary()`` equal to the JAX timer's on the same recorded
durations, ``marginal_ms``'s slope, retry and clamp equal to the
reference's on one scripted clock, and ``trace`` writing a Chrome trace on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from kubetpu.jobs import profiling as jprof
from kubetpu_torch.jobs import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("tokens_per_step", [0, 4096])
def test_step_timer_summary_matches_the_reference(tokens_per_step):
    """The same 300 durations into both timers: every field equal."""
    durations = np.random.default_rng(0).gamma(2.0, 0.01, 300)
    ours = profiling.StepTimer(tokens_per_step)
    ref = jprof.StepTimer(tokens_per_step)
    for s in durations:
        ours._rec.record("step", float(s))
        ref._rec.record("step", float(s))
    got, want = ours.summary(), ref.summary()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["count"] == 300
    assert ("tokens_per_s" in got) == bool(tokens_per_step)


def test_step_timer_times_blocks():
    timer = profiling.StepTimer(tokens_per_step=1024)
    x = torch.ones((32, 32))
    for _ in range(5):
        with timer.step():
            float((x @ x).sum())
    s = timer.summary()
    assert s["count"] == 5
    assert s["p50_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]
    assert s["tokens_per_s"] > 0
    assert profiling.StepTimer().summary() == {}


class ScriptedClock:
    """``time.perf_counter`` for both modules: each run of ``make_run(n)``
    advances it by ``cost(n, call)``; the fetch reads nothing."""

    def __init__(self, cost):
        self.now = 0.0
        self.calls = 0
        self.cost = cost

    def perf_counter(self):
        return self.now

    def make_run(self, n):
        def run():
            self.now += self.cost(n, self.calls)
            self.calls += 1
            return 0.0
        return run


@pytest.mark.parametrize("case", ["slope", "retry", "clamp"])
def test_marginal_ms_matches_the_reference(monkeypatch, capsys, case):
    """A 2 ms slope on a scripted clock; a first measurement whose noise
    makes it negative, then a clean retry; a slope that stays negative and
    is clamped to 1e-3 ms with a warning. Both packages read the same."""
    costs = {
        "slope": lambda n, c: 0.010 + 0.002 * n,
        # 3 reps x 2 variants + 2 warm-ups = 8 calls, then the retry
        "retry": lambda n, c: (0.010 - 0.001 * n if c < 8
                               else 0.010 + 0.002 * n),
        "clamp": lambda n, c: 0.010 - 0.001 * n,
    }
    got = {}
    for name, mod in (("port", profiling), ("ref", jprof)):
        clock = ScriptedClock(costs[case])
        monkeypatch.setattr(mod.time, "perf_counter", clock.perf_counter)
        got[name] = mod.marginal_ms(clock.make_run, 2, 6)
        monkeypatch.undo()
    assert got["port"] == pytest.approx(got["ref"], rel=1e-12)
    want = {"slope": 2.0, "retry": 2.0, "clamp": 1e-3}[case]
    assert got["port"] == pytest.approx(want, rel=1e-9)
    err = capsys.readouterr().err
    assert ("clamping to 1e-3 ms" in err) == (case == "clamp")


def test_fetch_scalar_reads_tensors_and_numbers():
    assert profiling.fetch_scalar(torch.tensor(2.5)) == 2.5
    assert profiling.fetch_scalar(np.float32(1.5)) == 1.5
    assert profiling.fetch_scalar(3) == 3.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones((64, 64))
    with profiling.trace(str(tmp_path / "run")):
        y = x @ x
    assert float(y[0, 0]) == 64.0
    files = os.listdir(tmp_path / "run")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "run" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
