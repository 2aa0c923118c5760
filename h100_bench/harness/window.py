"""The measured window: whole units, never a cut one.

A unit is one whole stream (or one lockstep set of streams) decoded, or
one whole clip encoded.  The window starts a unit while less than
`seconds` have passed since it opened, and closes when the last unit it
started returns, so a run may last up to one unit past `seconds` and
the frame types stay in the unit's own ratio.  A rate is the frames of
all units over the whole window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float
    end: float
    units: list = field(default_factory=list)
    unit_seconds: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run_window(run_unit, seconds: float, max_units=None,
               clock=time.perf_counter) -> Window:
    """Call run_unit(i) for i = 0, 1, ... while less than `seconds` have
    passed since the first call started (and, with max_units, fewer
    units than that have run); each call must return with its work
    finished (its outputs on the host)."""
    w = Window(clock(), 0.0)
    t = w.start
    while t - w.start < seconds and (max_units is None
                                     or len(w.units) < max_units):
        w.units.append(run_unit(len(w.units)))
        now = clock()
        w.unit_seconds.append(now - t)
        t = now
    w.end = t
    return w
