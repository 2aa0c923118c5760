"""What the readers of the port's own spans share.

The port keeps its spans in `thor_tpu_torch.trace` (one record a span:
unit, ids, thread, name, start and end on time.time_ns(), attrs), and
this module turns tracing on when it is imported.  Per-layer readers are
loaded only in a traced run, so an untraced run keeps the port's
tracing off.  A reader takes the records whose start lies inside one of
the harness's entry spans (`decode_stream`, `encode_sequence`: the
window's units, never the warm-up), per frame of the window.  Where the
port has no tracing module, or no record of a span, a reader returns
None and its metric is left out of the line.

Each record is drained from the port once a run; the idle time of the
device trace is put down to the innermost program span open across each
gap (`trace.idle_by_span`).  Both splits, host time and idle time by
span name, are logged once a run on standard error.
"""
from __future__ import annotations

import sys

from . import trace as TR
from .drivers import DRIVERS

try:
    from thor_tpu_torch import trace as PT
except ImportError:      # a port without spans of its own
    PT = None
else:
    PT.enable()

OUTSIDE = "outside the port's spans"
_runs = {}     # id(ctx) -> (ctx, records, idle seconds by span name)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def records(ctx):
    """The port's records of the window's units (those that start inside
    the harness's entry span), drained once a run."""
    got = _runs.get(id(ctx))
    if got is not None:
        return got[1]
    recs = []
    if PT is not None and ctx.spans is not None:
        entry = DRIVERS[ctx.driver].entry
        units = [(s, e) for s, e, n in ctx.spans.intervals if n == entry]
        recs = [r for r in PT.drain()
                if any(s <= r.start_ns < e for s, e in units)]
    idle = None
    if recs and ctx.trace is not None:
        idle = TR.idle_by_span(
            ctx.trace.gaps, [(r.start_ns, r.end_ns, r.name) for r in recs],
            OUTSIDE)
    _runs[id(ctx)] = (ctx, recs, idle)
    if recs:
        host = {}
        for r in recs:
            host[r.name] = host.get(r.name, 0.0) + (r.end_ns - r.start_ns)
        _log("program spans, host s: " + ", ".join(
            f"{n} {v * 1e-9:.6f}" for n, v in sorted(host.items())))
    if idle:
        _log("program spans, device idle s: " + ", ".join(
            f"{n} {v:.6f}" for n, v in sorted(idle.items())))
    return recs


def _named(ctx, names):
    if not ctx.frames:
        return []
    return [r for r in records(ctx) if r.name in names]


def host_ms_per_frame(ctx, *names):
    """Host milliseconds inside the named spans, summed over threads, per
    frame; the device work they queue runs on and is not waited for."""
    recs = _named(ctx, names)
    if not recs:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in recs) / ctx.frames


def count_per_frame(ctx, name, key):
    """A count the port adds on a span (`key` of its attrs), per frame."""
    recs = _named(ctx, (name,))
    if not recs:
        return None
    return sum(r.attrs.get(key, 0) for r in recs) / ctx.frames


def idle_ms_per_frame(ctx, name):
    """Milliseconds of device idle time whose gap has its middle inside
    the span (the innermost program span open there), per frame."""
    if ctx.trace is None or not _named(ctx, (name,)):
        return None
    return 1e3 * _runs[id(ctx)][2].get(name, 0.0) / ctx.frames
