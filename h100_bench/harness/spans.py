"""Spans recorded from the benchmark's own files, around the port's
callables, in a traced run.

A target is "package.module:attr" or "package.module:Class.method"; the
harness replaces it for the traced window by a wrapper and puts the
original back after.  The wrapper synchronises the device before the
call (that wait is not counted) and after it (that wait is), so a span
holds the call's host work and the device work it queued.  A rename in
the port orphans a span: its metric then finds nothing and is left out.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time


class Spans:
    def __init__(self, sync):
        self.sync = sync
        self.totals = {}      # name -> [seconds, calls]
        self.intervals = []   # (start_ns, end_ns, name), time.time_ns()
        self._lock = threading.Lock()   # a lockstep decode's threads

    def record(self, name, start_ns, end_ns):
        with self._lock:
            t = self.totals.setdefault(name, [0.0, 0])
            t[0] += (end_ns - start_ns) * 1e-9
            t[1] += 1
            self.intervals.append((start_ns, end_ns, name))

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            self.sync()
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                self.record(name, t0, time.time_ns())
        return spanned

    def seconds(self, name):
        """Total seconds of a span name, or None where it never ran."""
        t = self.totals.get(name)
        return t[0] if t and t[1] else None


def resolve(target: str):
    """(owner, attribute name) of a "module:attr.path" target."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


@contextlib.contextmanager
def patched(replacements):
    """replacements: (target, make) pairs; make(original) returns what
    the target holds inside the block.  Every target is restored."""
    saved = []
    try:
        for target, make in replacements:
            owner, attr = resolve(target)
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, make(orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def span_replacements(spans: Spans, targets: dict):
    """targets: {span name: [target, ...]}."""
    return [(t, functools.partial(spans.wrap, name))
            for name, ts in targets.items() for t in ts]
