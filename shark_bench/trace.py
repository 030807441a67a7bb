"""The traced window: `torch.profiler` around a few steady steps or batches,
read into plain lists that the per-layer readers take their metrics from.

The window is the span from the first device operation's start to the last
one's end, so the profiler's own start and stop stay outside it; it still
holds the profiler's cost per host operation, which the untraced window
does not pay (PERF.md gives the traced step time beside the untraced one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from . import yardstick

Op = Tuple[str, float, float]   # name, start and end in microseconds


@dataclasses.dataclass
class Trace:
    device_ops: List[Op]
    host_ops: List[Op]

    @property
    def window_us(self) -> float:
        if not self.device_ops:
            return 0.0
        return (max(e for _, _, e in self.device_ops)
                - min(s for _, s, _ in self.device_ops))

    @property
    def busy_us(self) -> float:
        return yardstick.union([(s, e) for _, s, e in self.device_ops])

    def kernel_us(self, pattern) -> Tuple[int, float]:
        """(launches, device microseconds) of the operations whose name
        matches the compiled regular expression `pattern`."""
        hits = [(s, e) for n, s, e in self.device_ops if pattern.search(n)]
        return len(hits), sum(e - s for s, e in hits)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by what the host was doing at its middle: the
        benchmark's span and the innermost host operation open then."""
        spans = sorted((s, e) for _, s, e in self.device_ops)
        longest = sorted(yardstick.gaps(spans), key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host_ops, key=lambda o: o[1])
        named = []
        for a, b in longest:
            mid = (a + b) / 2
            outer, inner = "", "no host operation"
            for name, s, e in host:
                if s > mid:
                    break
                if e >= mid:
                    if name.startswith("shark_bench."):
                        outer = name
                    else:
                        inner = name
            named.append([f"{outer}: {inner}" if outer else inner,
                          (b - a) / 1e6])
        return {"device_ops": yardstick.top_ops(self.device_ops, n),
                "idle_gaps": named}


def capture(fn: Callable[[], None], cuda: bool) -> Trace:
    """Run fn() under the profiler and return its trace.  The profiler is
    started once beforehand, so that its set-up stays out of the trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        if cuda:
            torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        op = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type().name != "CUDA":
            host.append(op)
        elif not (e.is_user_annotation()
                  or e.name().startswith("shark_bench.")):
            # kernels, copies and sets; a `record_function` span shows on
            # the device's timeline too, and is no device work
            dev.append(op)
    return Trace(dev, host)
