"""The device trace of a traced window: torch.profiler with CUDA activity
only, reduced here to the device's busy time, the time of kernels by
name, and the idle time summed by the span open across each gap.

Busy time is the union of every device activity (kernels, copies, sets)
inside the window; the window is the host's clock from the profiler's
start to its stop, both after a synchronise.  Kineto gives activity
times on the host's wall clock (time.time_ns), the clock of the spans.
"""
from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict          # name -> [device seconds, launches]
    gaps: list             # (start_ns, end_ns) of idle time, in order
    events: int

    def kernel_seconds(self, part: str):
        """(seconds, launches) of the kernels whose name holds `part`."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if part in name:
                s += sec
                n += cnt
        return s, n


class DeviceTrace:
    """Context manager over the traced window (CUDA only)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t0
        return False

    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        cuda = DeviceType.CUDA
        acts = [(e.start_ns(), e.duration_ns(), e.name())
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == cuda]
        out = reduce_activities(acts, self.start_ns, self.end_ns)
        self.reduce_s = time.perf_counter() - t0
        return out


def reduce_activities(acts, start_ns: int, end_ns: int) -> TraceSummary:
    """acts: (start_ns, duration_ns, name) of device activities."""
    kernels = {}
    spans = []
    for s, d, name in acts:
        s, e = max(s, start_ns), min(s + d, end_ns)
        if e <= s:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-9
        k[1] += 1
        spans.append((s, e))
    spans.sort()
    busy = 0
    gaps = []
    cur = start_ns
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if end_ns > cur:
        gaps.append((cur, end_ns))
    return TraceSummary((end_ns - start_ns) * 1e-9, busy * 1e-9, kernels,
                        gaps, len(acts))


def idle_by_span(gaps, intervals, outside: str) -> dict:
    """Idle seconds summed by the innermost span (the latest started)
    open at each gap's middle; gaps in time order."""
    points = sorted({p for s, e, _ in intervals for p in (s, e)})
    segments = []          # (segment start, innermost span's name)
    for a, b in zip(points, points[1:]):
        open_ = [(s, n) for s, e, n in intervals if s <= a and b <= e]
        segments.append((a, max(open_)[1] if open_ else outside))
    out = {}
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i + 1 < len(segments) and segments[i + 1][0] <= mid:
            i += 1
        inside = segments and segments[i][0] <= mid < points[i + 1]
        name = segments[i][1] if inside else outside
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out


def short_name(name: str, cap: int = 160) -> str:
    """A kernel's name without its return type, its argument list and
    the at::native:: and std:: prefixes, at most `cap` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    name = name.replace("at::native::", "").replace("std::", "")
    return name[:cap] or "(unnamed device activity)"


def breakdown(summary: TraceSummary, intervals, outside: str) -> dict:
    """The 10 device operations that took most time, and the idle time
    summed by what the host was doing (the span open across it)."""
    by_name = {}
    for n, (sec, _) in summary.kernels.items():
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by_span(summary.gaps, intervals, outside).items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
