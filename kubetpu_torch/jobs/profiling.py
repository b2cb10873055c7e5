"""Tracing and step timing for the jobs layer (port of
``kubetpu/jobs/profiling.py``).

- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (JSON, loadable in Perfetto or
  ``chrome://tracing``) of whatever runs inside, with the card's kernels
  when CUDA is present. The trace is written with
  ``export_chrome_trace``; nothing imports tensorboard.
- ``StepTimer``: wall-clock step statistics (p50/p99 + tokens/sec) over the
  port's ``core.metrics.LatencyRecorder``.
- ``marginal_ms``: the two-point slope ``(t2 - t1) / (n2 - n1)`` of an op
  run n1 and n2 times, each timed around a forced scalar fetch, so that
  fixed costs (dispatch, the fetch) cancel. The JAX package runs the n
  iterations inside one compiled program; here ``make_run(n)`` may return
  n eager calls, each paying its host dispatch, so where the op is shorter
  than that dispatch the slope measures the host. A ``make_run`` that
  replays a CUDA graph of n calls removes the dispatch
  (``chip_smoke.py`` phase 33 measures both beside CUDA events).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

import torch

from kubetpu_torch.core.metrics import LatencyRecorder


def fetch_scalar(x) -> float:
    """Force a device -> host read of a scalar (``.item()``): the fence
    that cannot return before the device has produced the value."""
    if isinstance(x, torch.Tensor):
        return float(x.item())
    return float(x)


def marginal_ms(make_run, n1: int, n2: int, reps: int = 3) -> float:
    """Marginal milliseconds per iteration of an op.

    ``make_run(n)`` returns a zero-argument callable that runs the op *n*
    times (with a data dependency between iterations) and returns a device
    scalar. Each variant is warmed once, then timed ``reps`` times around
    a forced scalar fetch; the best wall time per variant enters the
    two-point slope. A non-positive slope (noise larger than the op) is
    measured once more at twice the reps, then clamped to 1e-3 ms with a
    warning on stderr."""
    def measure(reps_now: int) -> float:
        best = {}
        for n in (n1, n2):
            run = make_run(n)
            fetch_scalar(run())  # warm
            times = []
            for _ in range(reps_now):
                t0 = time.perf_counter()
                fetch_scalar(run())
                times.append(time.perf_counter() - t0)
            best[n] = min(times)
        return (best[n2] - best[n1]) / (n2 - n1) * 1e3

    ms = measure(reps)
    if ms <= 0:
        ms = measure(reps * 2)
        if ms <= 0:
            print(
                f"marginal_ms: non-positive slope ({ms:.4f} ms) even at "
                f"reps={reps * 2}; clamping to 1e-3 ms — treat this "
                "measurement as noise-dominated",
                file=sys.stderr,
            )
            ms = 1e-3
    return ms


@contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into *log_dir*
    (``trace-<pid>-<ns>.json``, Chrome trace format): host operators, and
    the card's kernels when CUDA is available. Wrap a few warmed-up steps
    — tracing a first call's kernel builds swamps the timeline."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepTimer:
    """Time training or decode steps and report tokens/sec.

    >>> timer = StepTimer(tokens_per_step=batch * seq)
    >>> for ... :
    ...     with timer.step():
    ...         state, loss = train_step(state, tokens, targets)
    ...         float(loss)
    >>> timer.summary()   # {"p50_ms": ..., "p99_ms": ..., "tokens_per_s": ...}

    The timed block must wait for the device (read the loss, or
    ``torch.cuda.synchronize()``): the card runs behind the host, so
    without it the numbers are enqueue times, not step times.
    """

    def __init__(self, tokens_per_step: int = 0):
        self.tokens_per_step = tokens_per_step
        self._rec = LatencyRecorder()

    @contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._rec.record("step", time.perf_counter() - t0)

    def summary(self) -> dict:
        stats = self._rec.summary().get("step")
        if not stats:
            return {}
        out = dict(stats)
        if self.tokens_per_step and stats.get("p50_ms"):
            out["tokens_per_s"] = round(
                self.tokens_per_step / (stats["p50_ms"] / 1e3), 1
            )
        return out
