"""What the per-layer readers share: a model's work over a window, and a
kernel's share of its roofline in a traced window."""

from __future__ import annotations

from shark_bench import yardstick
from shark_bench.spec import family


def mfu(rec, kind: str, flops) -> "float | None":
    """Model FLOPs of the work the measured window completed, over the
    window's length times the card's bf16 peak, in percent."""
    if rec.kind != kind or not rec.work or rec.window_s <= 0:
        return None
    total = sum(flops(rec.spec, b, s) for b, s in rec.work)
    return 100.0 * total / (rec.window_s * yardstick.PEAK_FLOPS)


def roofline(rec, kind: str, kernel: str, pattern) -> "float | None":
    """The least time of the work the configuration's family charges to
    `kernel` (`kernels` in `families/<family>.py`: calls and cost of each
    call in a pass over a traced step's or batch's shape), over the device
    time of the kernels whose names match `pattern`, in percent."""
    if rec.kind != kind or rec.trace is None or not rec.traced_work:
        return None
    work = [family(rec.spec).kernels(rec.spec, b, s)
            for b, s in rec.traced_work]
    if kernel not in work[0]:
        return None
    launches, us = rec.trace.kernel_us(pattern)
    if launches == 0 or us <= 0:
        return None
    least = sum(w[kernel][0] * yardstick.bound_s(w[kernel][1]) for w in work)
    return 100.0 * least / (us / 1e6)


def idle_share(rec, kind: str) -> "float | None":
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    if rec.kind != kind or rec.trace is None or rec.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_us / rec.trace.window_us)
