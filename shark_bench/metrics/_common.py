"""What the per-layer readers share: a model's work over a window, and a
kernel's share of its roofline in a traced window."""

from __future__ import annotations

from shark_bench import yardstick


def mfu(rec, kind: str, flops) -> "float | None":
    """Model FLOPs of the work the measured window completed, over the
    window's length times the card's bf16 peak, in percent."""
    if rec.kind != kind or not rec.work or rec.window_s <= 0:
        return None
    total = sum(flops(rec.spec, b, s) for b, s in rec.work)
    return 100.0 * total / (rec.window_s * yardstick.PEAK_FLOPS)


def mixer_roofline(rec, kind: str, family: str, pattern) -> "float | None":
    """The least time of every layer's mixer forward in the traced window's
    steps or batches (one forward a layer each), over the device time of
    the kernels whose names match `pattern`, in percent."""
    if (rec.kind != kind or rec.spec.family != family or rec.trace is None
            or not rec.traced_work):
        return None
    launches, us = rec.trace.kernel_us(pattern)
    if launches == 0 or us <= 0:
        return None
    least = sum(rec.spec.n_layers
                * yardstick.bound_s(yardstick.mixer_cost(rec.spec, b, s))
                for b, s in rec.traced_work)
    return 100.0 * least / (us / 1e6)


def idle_share(rec, kind: str) -> "float | None":
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    if rec.kind != kind or rec.trace is None or rec.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_us / rec.trace.window_us)
