"""Drives ``kubetpu_torch.jobs.paged.PagedDecodeServer`` in-process through
``enqueue`` and ``step``, as its own clients would, and keeps the
benchmark's record of every request and step.

An open loop enqueues each request when it falls due, whatever the server
is doing, and times it from its due time; after the window no new request
arrives and the loop runs until every request due in the window has all
its tokens, or a minute past the close (above the knee, where the queue
grows by design, it ends at the close). A closed loop keeps ``clients``
sequences in flight and starts the next one as each finishes. A client
reads ``out_len`` tokens and then cancels its request (the server's
``max_new_tokens`` is the mix's longest output). Nothing here sleeps while
the server has work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from portbench.gen import Request

DRAIN_S = 60.0          # how long past the close a due request is awaited


@dataclasses.dataclass
class Served:
    req: Request
    rid: int
    sent: float                      # perf_counter when enqueued
    due: float                       # perf_counter it was due
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0               # prompt tokens the record has seen
    done: bool = False
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Step:
    """One ``step()`` call as the record sees it: host times, the prompt
    tokens each prefill chunk of the call carried (with the chunk's start),
    and the context length of every decode row that reached the client."""
    t0: float
    t1: float
    chunks: List[tuple]              # (start position, real tokens)
    decode_ctx: List[int]


class Record:
    def __init__(self) -> None:
        self.served: Dict[int, Served] = {}
        self.steps: List[Step] = []
        self.lateness: List[float] = []
        self.window = (0.0, 0.0)

    def in_window(self) -> List[Served]:
        return [s for s in self.served.values() if s.req.in_window]


def _span(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"portbench.{name}")


class Driver:
    """One server, one record; ``step_once`` is the loop's body."""

    def __init__(self, server, trace: bool = False) -> None:
        self.server = server
        self.trace = trace
        self.rec = Record()
        self.prefilling: Dict[int, Served] = {}
        self.active: Dict[int, Served] = {}
        # (trace.Slice, host time to start it, seconds it lasts)
        self.trace_plan = None

    def send(self, req: Request, due: float) -> None:
        now = time.perf_counter()
        with _span(self.trace, "enqueue"):
            rid = self.server.enqueue(req.prompt)
        s = Served(req, rid, now, due)
        self.rec.served[rid] = s
        self.prefilling[rid] = s
        self.active[rid] = s
        self.rec.lateness.append(now - due)

    def runnable(self) -> bool:
        return bool(self.active)

    def _tick_trace(self, now: float) -> None:
        sl, on, length = self.trace_plan
        if not sl.t0 and now >= on:
            sl.start()
        elif sl.t0 and now >= sl.t0 + length:
            sl.stop()
            self.trace_plan = None

    def step_once(self) -> List[Served]:
        """One ``step()``; -> the requests that finished in it."""
        if self.trace_plan is not None:
            self._tick_trace(time.perf_counter())
        t0 = time.perf_counter()
        with _span(self.trace, "step"):
            out = self.server.step()
        t1 = time.perf_counter()
        chunks, decode_ctx, finished = [], [], []
        for rid, s in list(self.prefilling.items()):
            prog = self.server.prefill_progress(rid)
            done = (len(s.req.prompt) if rid in out
                    else (prog[0] if prog else s.prefilled))
            if done > s.prefilled:
                chunks.append((s.prefilled, done - s.prefilled))
                s.prefilled = done
            if rid in out:
                del self.prefilling[rid]
        for rid, toks in out.items():
            s = self.active.get(rid)
            if s is None:
                continue
            take = toks[:s.req.out_len - len(s.tokens)]
            for _ in take:
                if s.tokens:
                    decode_ctx.append(len(s.req.prompt) + len(s.tokens))
                s.tokens.append(_)
                s.times.append(t1)
            if len(s.tokens) >= s.req.out_len:
                s.logprobs = self.server.result_logprobs(rid)[:len(s.tokens)]
                with _span(self.trace, "cancel"):
                    self.server.cancel(rid)
                s.done = True
                del self.active[rid]
                finished.append(s)
        self.rec.steps.append(Step(t0, t1, chunks, decode_ctx))
        return finished

    def close(self) -> None:
        """Cancel what is left and flush the server's pipeline."""
        for rid in list(self.active):
            self.server.cancel(rid)
        self.active.clear()
        self.prefilling.clear()
        self.server.drain()


def open_loop(driver: Driver, reqs: List[Request], start: float,
              seconds: float, drain: bool = True) -> None:
    """Enqueue *reqs* at ``start + req.due`` (pre-roll ones before
    *start*) and step the server; returns once every request due in the
    window is finished or ``DRAIN_S`` after the close, or with
    ``drain=False`` (a rate above what the server completes) at the
    close."""
    close = start + seconds
    i = 0
    waiting = {id(r) for r in reqs if r.in_window}
    while True:
        now = time.perf_counter()
        # every request due in the window is sent, also one that the
        # loop reaches only after the close
        while i < len(reqs) and start + reqs[i].due <= min(now, close):
            driver.send(reqs[i], start + reqs[i].due)
            i += 1
        if driver.runnable():
            for s in driver.step_once():
                waiting.discard(id(s.req))
        elif now >= close:
            break
        else:
            nxt = start + reqs[i].due if i < len(reqs) else close
            with _span(driver.trace, "idle"):
                time.sleep(max(0.0, min(nxt, close) - now))
        now = time.perf_counter()
        if now >= close and i == len(reqs) and (
                not drain or not waiting or now >= close + DRAIN_S):
            break
    driver.rec.window = (start, close)


def closed_loop(driver: Driver, first: List[Request], refills: List[Request],
                clients: int, preroll_s: float, ready) -> None:
    """Keep *clients* sequences in flight: the first wave, then a refill as
    each finishes. ``preroll_s`` after every first-wave sequence is
    decoding, ``ready()`` returns the window's (start, close); the loop
    ends at the close."""
    queue = list(refills)
    for req in first[:clients]:
        driver.send(req, time.perf_counter())
    wave = set(driver.prefilling)
    go: Optional[float] = None
    close: Optional[float] = None
    while close is None or time.perf_counter() < close:
        for _ in driver.step_once():
            if not queue:
                raise RuntimeError("the mix ran out of refills")
            req = queue.pop(0)
            driver.send(req, time.perf_counter())
        if go is None and not wave & set(driver.prefilling):
            go = time.perf_counter() + preroll_s
        if close is None and go is not None and time.perf_counter() >= go:
            start, close = ready()
            driver.rec.window = (start, close)


def latencies(served: List[Served]):
    """(TTFT ms of every request, inf where none came; every gap ms
    between consecutive tokens of every request)."""
    ttft, gaps = [], []
    for s in served:
        ttft.append((s.times[0] - s.due) * 1e3 if s.times else float("inf"))
        gaps += list(np.diff(np.asarray(s.times)) * 1e3)
    return ttft, gaps
