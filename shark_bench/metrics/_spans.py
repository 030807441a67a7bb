"""What the readers of the program's spans share.

The program marks its phases with `record_function` ranges named
`repro_torch.<phase>` (`src/repro_torch/spans.py`); the traced window keeps
them among its host operations, on the device operations' clock.  A
device operation is credited to the span in which the host launched it,
whichever thread launched it (autograd's own thread launches the
backward's kernels while the caller waits inside `train.backward`).

A traced window holds one stream's operations, which the card runs in the
order they were launched: the k-th launch call on the host (`LAUNCH`: a
kernel launch, a copy or a set) is the k-th device operation by start.
The profiler may lose a few records, of launches or of device
operations; each lost one shifts the pairing after it by one, which
moves at most one operation across each later span boundary.  Where the
counts differ by more than `LOST` of the device operations, or no launch
was recorded, the launches cannot be told and the readers that need them
return None.  Every reader returns None on another kind's record,
without a trace, on a trace with no device operation, or without the
span: never 0 for what it could not see.
Each reading is per traced step or batch.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Sequence, Tuple

from shark_bench import yardstick

SPAN = "repro_torch."
# the host calls that put one operation on the device's stream
LAUNCH = re.compile(r"^cu(da)?(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")
# the most records, as a share of the device operations, the profiler may
# lose before the launches count as unknown (the H100 lost 0.07% at most)
LOST = 0.01
# the host calls that wait for the device
SYNC = re.compile(r"^cuda(Stream|Device|Event)Synchronize$")


def _trace(rec, kind: str):
    """The record's trace, where it is of `kind` and saw the device."""
    if (rec.kind != kind or rec.trace is None or not rec.traced_work
            or not rec.trace.device_ops):
        return None
    return rec.trace


def launch_times(trace) -> Optional[List[float]]:
    """Each device operation's launch on the host's clock, in the order of
    `trace.device_ops`, or None where the launches cannot be told."""
    dev = trace.device_ops
    launches = sorted(s for n, s, _ in trace.host_ops if LAUNCH.match(n))
    if not launches or abs(len(launches) - len(dev)) > LOST * len(dev):
        return None
    out = [0.0] * len(dev)
    for k, i in enumerate(sorted(range(len(dev)), key=lambda i: dev[i][1])):
        out[i] = launches[min(k, len(launches) - 1)]
    return out


def spans(trace, name: str) -> List[Tuple[float, float]]:
    """The host intervals of the program's spans `name`, in time order;
    `name` may end in "." for every span under it ("" for all)."""
    full = SPAN + name
    return sorted((s, e) for n, s, e in trace.host_ops
                  if (n.startswith(full) if full.endswith(".")
                      else n == full))


def _inside(t: float, iv: Sequence[Tuple[float, float]]) -> bool:
    """Whether t lies in one of the disjoint, sorted intervals `iv`."""
    k = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return k >= 0 and iv[k][0] <= t <= iv[k][1]


def device_ms(rec, kind: str, name: str) -> Optional[float]:
    """Device milliseconds a step or batch of the operations launched
    inside the spans `name`."""
    trace = _trace(rec, kind)
    if trace is None:
        return None
    iv = spans(trace, name)
    launched = launch_times(trace) if iv else None
    if launched is None:
        return None
    us = sum(e - s for (_, s, e), t in zip(trace.device_ops, launched)
             if _inside(t, iv))
    return us / 1e3 / len(rec.traced_work)


def idle_ms(rec, kind: str, name: str) -> Optional[float]:
    """Milliseconds a step or batch in which the device ran nothing while
    the host was inside the spans `name`: the gaps between the device
    operations' union, cut to the spans."""
    trace = _trace(rec, kind)
    iv = spans(trace, name) if trace is not None else []
    if not iv:
        return None
    us = sum(max(0.0, min(b, e) - max(a, s))
             for a, b in yardstick.gaps([(s, e) for _, s, e in
                                         trace.device_ops])
             for s, e in iv)
    return us / 1e3 / len(rec.traced_work)


def host_ms(rec, kind: str, name: str) -> Optional[float]:
    """Host milliseconds a step or batch inside the spans `name`."""
    trace = _trace(rec, kind)
    iv = spans(trace, name) if trace is not None else []
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e3 / len(rec.traced_work)


def count(rec, kind: str, pattern) -> Optional[float]:
    """Host operations a step or batch whose names match `pattern` and
    which start inside a span of the program (its spans never overlap)."""
    trace = _trace(rec, kind)
    iv = spans(trace, "") if trace is not None else []
    if not iv:
        return None
    n = sum(1 for name, s, _ in trace.host_ops
            if pattern.search(name) and _inside(s, iv))
    return n / len(rec.traced_work)
