"""What the metric readers under `metrics/` share.  A reader returns
None where it finds nothing to read, and the metric is then left out of
the run's line; a share of a roofline is never made 0 or capped."""
from __future__ import annotations


def frames_per_s(ctx, driver):
    """Frames of the window's units over the whole window."""
    if ctx.driver != driver or not ctx.frames:
        return None
    return ctx.frames / ctx.window.seconds


def span_ms_per_frame(ctx, name):
    """A span's host milliseconds, device work it waited for included,
    per frame of the window."""
    if ctx.spans is None or not ctx.frames:
        return None
    s = ctx.spans.seconds(name)
    return None if s is None else 1e3 * s / ctx.frames


def mc_roofline(ctx):
    """Percent: the MC launches' summed bound time over their summed
    device time in the trace, where the trace timed exactly the
    launches the recorder saw."""
    from harness.roofline import MC_KERNEL
    if ctx.trace is None or ctx.mc is None or not ctx.mc.calls:
        return None
    dev_s, launches = ctx.trace.kernel_seconds(MC_KERNEL)
    bound_ms, calls = ctx.mc.bound_ms()
    if launches != calls or dev_s <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 / dev_s


def idle_share(ctx):
    """Percent of the traced window in which no device activity ran."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
