"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of the window, reduced to what the per-layer readers take.

- busy: the union of every device activity's interval (kernels, copies,
  sets), and the slice's length on the host clock, which ends in a
  synchronize;
- device time by kernel name, and the device time of the kernels that
  ``aten::bmm`` launched (matched through each launch's correlation id):
  all of them, and those of the calls whose input shapes the slice's
  *expert_shapes* accepts (the profiler records shapes);
- the longest idle gaps of the device, each named by the benchmark span
  and the innermost host operation running when it began.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
           "cudaLaunchCooperativeKernel", "cuLaunchKernelEx")


class Slice:
    """Start with ``start()``, end with ``stop()``, and once the window is
    over ``reduce()`` the trace (seconds of Python work that must not stall
    the loop); then read the fields."""

    def __init__(self, expert_shapes: Optional[Callable] = None) -> None:
        self.t0 = self.t1 = 0.0
        self.busy_s = 0.0
        self.kernel_s: Dict[str, float] = {}
        self.expert_shapes = expert_shapes
        self.bmm_all_s: Optional[float] = None
        self.bmm_s: Optional[float] = None
        self.gaps: List[list] = []
        self._prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True)

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        print(f"traced slice: {self.window_s:.3f} s, profiler stopped in "
              f"{time.perf_counter() - self.t1:.3f} s", file=sys.stderr)

    def reduce(self) -> None:
        t = time.perf_counter()
        self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None
        print(f"trace reduced in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

    def kernels_matching(self, *fragments: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds a fragment; None
        when none ran."""
        hit = [s for n, s in self.kernel_s.items()
               if any(f in n for f in fragments)]
        return sum(hit) if hit else None

    def top_ops(self, n: int = 10) -> List[list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in ops]

    def _reduce(self, events) -> None:
        dev, cpu, experts = [], [], set()
        for e in events:
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                   e.correlation_id())
            if (rec[2] == "aten::bmm" and self.expert_shapes is not None
                    and self.expert_shapes(e.shapes())):
                experts.add(rec[:2])
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a host range mirrored on the device's timeline is no
                # device operation
                if not (e.is_user_annotation()
                        or rec[2].startswith("portbench.")):
                    dev.append(rec)
            else:
                cpu.append(rec)
        dev.sort()
        by_name: Dict[str, float] = defaultdict(float)
        merged: List[list] = []
        for s, t, name, _c in dev:
            by_name[name] += (t - s) * 1e-9
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.kernel_s = dict(by_name)
        self.busy_s = sum(t - s for s, t in merged) * 1e-9
        self.bmm_all_s = self._bmm_seconds(dev, cpu, None)
        self.bmm_s = self._bmm_seconds(dev, cpu, experts)
        print(f"aten::bmm device s: all {self.bmm_all_s}, of the experts' "
              f"shapes {self.bmm_s}", file=sys.stderr)
        self.gaps = self._gaps(merged, cpu)

    @staticmethod
    def _bmm_seconds(dev, cpu, keep) -> Optional[float]:
        """Device seconds of the kernels launched inside ``aten::bmm``
        calls (those whose (start, end) *keep* holds, or all with None)."""
        bmm = sorted((s, t) for s, t, n, _c in cpu if n == "aten::bmm"
                     and (keep is None or (s, t) in keep))
        if not bmm:
            return None
        starts = [s for s, _t in bmm]
        corr = set()
        for s, _t, name, c in cpu:
            if name in _LAUNCH:
                i = bisect.bisect_right(starts, s) - 1
                if i >= 0 and s <= bmm[i][1]:
                    corr.add(c)
        secs = sum(t - s for s, t, _n, c in dev if c in corr) * 1e-9
        return secs if corr else None

    @staticmethod
    def _gaps(merged, cpu, n: int = 10) -> List[list]:
        spans = [(t - s, s) for (_a, s), (t, _b) in zip(merged, merged[1:])]
        spans.sort(reverse=True)
        out = []
        for length, at in spans[:n]:
            cover = [(t - s, name) for s, t, name, _c in cpu
                     if s <= at < t]
            bench = [c for c in cover if c[1].startswith("portbench.")]
            inner = min(cover)[1] if cover else "no host op"
            outer = max(bench)[1] if bench else "-"
            out.append([f"{outer} > {inner}", length * 1e-9])
        return out


def expert_shapes(m: dict) -> Callable:
    """Whether an ``aten::bmm`` call's input shapes are an expert
    product's: (E, rows, K) by (E, K, N) with E the configuration's experts
    and (K, N) the gate or up weight (d, d_ff) or the down one (d_ff, d).
    The paged path's projections, router and head also reach ``aten::bmm``
    through ``einsum``, with a batch of 1."""
    e, d, f = m.get("n_experts", 0), m["d_model"], m["d_ff"]

    def accept(shapes) -> bool:
        if not e or len(shapes) < 2 or len(shapes[0]) != 3:
            return False
        a, w = list(shapes[0]), list(shapes[1])
        return a[0] == e and w in ([e, d, f], [e, f, d])

    return accept
