"""The port's spans and counters: what the host does, on the clock of the
device trace.

Spans.  `span(name, **attrs)` is a context manager around a piece of the
port's host work; `unit(name, **attrs)` is the same at the root of one
`decode_stream` or `encode_sequence` call, and gives the spans under it a
new unit id; `spanned(name)` puts a function's body in a span.  While
tracing is on, a span that closes keeps one `Record`: its unit, its own
id, the id of the span open around it in the same thread (None at a
root), the thread, its name, its start and end on `time.time_ns()` (the
clock of torch.profiler's device activities, so an idle gap of the
device can be put down to the span open across it) and its attrs.
`add(**counts)`, or a span's own `add`, adds numbers to the open span's
attrs.  Records stay in memory until `drain()`
returns and clears them.  While tracing is off, `span` and `unit` return
one shared no-op object and nothing is kept.  No span synchronises the
device: a span times the host's work, the device work it queued runs on.

Tracing has one switch, `enable(on=True)`, and is off by default: the
one who turns it on drains the records.

Counters are always on: plain integers under one lock, so that threads
(the lockstep decode, the multi-stream encode) lose no count.
`count(name, n=1)`, `counter(name)` (0 for a name never counted) and
`reset(*names)` (every counter where no name is given).  The port's:
`mc.luma_launches`, `mc.chroma_uv_launches` and `mc.chroma_launches`
(kernel launches of ops/mc.py: luma, chroma U+V, chroma of one plane)
`dec.route.<route>` (frames decoded by each route of
dec/decoder.py, `decoder.route_frames()`) and
`dec.intra_kernel_segments` (intra wave segments launched by the kernel
of csrc/intra_wave.cu).

The port's spans, by layer (counts on the span in brackets):
- decode: `dec.stream` (the unit's root) > `dec.frame` (one per
  Decoder.decode_frame) > `dec.native_parse` (the C block parser) and
  `dec.device_frame` (DeviceFrameDecoder.run) > `dec.frame_prep` (its
  host work before pixel_core) and `dec.intra_waves` (the intra wave
  scan's issue: the kernel's one call on the card, the host loop over
  the segments on the CPU, [segments]);
- lockstep decode (dec/multistream.py): `dec.rendezvous` (each
  Rendezvous.wait of a stream thread), `dec.batch_exec` (the batched
  executor on thread 0);
- turbo encode: `enc.clip` (the unit's root) > `enc.frame` >
  `enc.turbo` (decide_frame), `enc.plan` (the C or Python plan walk),
  `enc.turbo_final` (finalize_core) > `enc.intra_waves`, `enc.emit`
  (the C or Python emit), `enc.encoder` (the frame tail) >
  `enc.clpf_apply`.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

_on = False
_lock = threading.Lock()
_records = []
_counters = {}
_span_ids = itertools.count(1)
_unit_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    unit: int | None
    span_id: int
    parent_id: int | None
    thread_id: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


def enable(on: bool = True):
    """Turns tracing on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "attrs", "new_unit", "unit", "span_id",
                 "parent_id", "start_ns")

    def __init__(self, name, attrs, new_unit):
        self.name = name
        self.attrs = attrs
        self.new_unit = new_unit

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        self.span_id = next(_span_ids)
        self.parent_id = parent.span_id if parent else None
        self.unit = (next(_unit_ids) if self.new_unit
                     else parent.unit if parent else None)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        rec = Record(self.unit, self.span_id, self.parent_id,
                     threading.get_ident(), self.name, self.start_ns, end,
                     self.attrs)
        with _lock:
            _records.append(rec)
        return False

    def add(self, **counts):
        for k, v in counts.items():
            self.attrs[k] = self.attrs.get(k, 0) + v


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span of the host's work (see the module docstring)."""
    return _Span(name, attrs, False) if _on else NO_SPAN


def unit(name: str, **attrs):
    """The root span of one decode_stream or encode_sequence call."""
    return _Span(name, attrs, True) if _on else NO_SPAN


def spanned(name: str, root: bool = False):
    """Decorator: the function's body in a span (`unit` with root)."""
    make = unit if root else span

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with make(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def add(**counts):
    """Adds to the attrs of the innermost span open in this thread."""
    stack = _local.__dict__.get("stack")
    if _on and stack:
        stack[-1].add(**counts)


def drain() -> list:
    """The records kept since the last drain, in the order their spans
    closed; clears them."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def reset(*names):
    """Sets the named counters to 0; every counter where none is named."""
    with _lock:
        if not names:
            _counters.clear()
        for n in names:
            _counters.pop(n, None)
