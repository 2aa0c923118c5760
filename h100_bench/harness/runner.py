"""One run of one cell: set-up, the window, the judge, the metrics.

The driver sets up (imports the port, builds what it builds, makes or
reads the inputs, warms up on the smallest input of the same route); the
window runs whole units; then the device's peak memory is read, the
port's state is freed, and the outputs are judged.  With `trace` the
per-layer readers' spans are installed around the port's callables and
the device is traced, and the window is the first unit alone: the
profiler's reduction of one 1080p stream's 2.8 M device activities takes
minutes, so a second traced unit would not fit a run's time.  Without
`trace` nothing is wrapped.
"""
from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass

from . import drivers, judge, manifest, spans as S, trace as TR
from .roofline import McCalls
from .window import Window, run_window

OUTSIDE = "host, outside the wrapped calls"


def process_seconds() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclass
class Context:
    """What a metric's reader reads."""
    driver: str
    setup_s: float
    window: Window
    frames: int
    spans: S.Spans | None = None
    trace: TR.TraceSummary | None = None
    mc: McCalls | None = None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(bench: dict, cell: manifest.Cell, seed: int, seconds: float,
        trace: bool, device=None) -> dict:
    import torch
    on_card = device is None or str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    section = "per_layer" if trace else "end_to_end"
    entries = manifest.metrics_of(bench, cell.name, section)
    readers = {m["name"]: manifest.load_reader(m["name"]) for m in entries}

    drv = drivers.make(cell, seed, device)
    drv.setup()
    sync()
    setup_s = process_seconds()
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    spans = mc = tracer = None
    run_unit = drv.run_unit
    replacements = []
    if trace:
        spans = S.Spans(sync)
        targets = {}
        for r in readers.values():
            targets.update(getattr(r, "SPANS", {}))
        replacements = S.span_replacements(spans, targets)
        if any("mc_calls" in getattr(r, "NEEDS", ())
               for r in readers.values()):
            mc = McCalls()
            replacements += mc.replacements()
        run_unit = spans.wrap(drv.entry, drv.run_unit)
        if on_card:
            tracer = TR.DeviceTrace()

    max_units = 1 if trace else None
    with S.patched(replacements):
        if tracer is not None:
            with tracer:
                window = run_window(run_unit, seconds, max_units)
        else:
            window = run_window(run_unit, seconds, max_units)
    log("units " + " ".join(f"{s:.3f}" for s in window.unit_seconds)
        + f" s; window {window.seconds:.3f} s")

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": cell.chips,
                   "memory_peak_bytes": max(
                       torch.cuda.max_memory_allocated(d)
                       for d in range(cell.chips)) if on_card else 0}
    summary = tracer.summary() if tracer is not None else None
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        log(f"trace: {summary.events} device activities; the profiler "
            f"stopped in {tracer.stop_s:.3f} s, reduced in "
            f"{tracer.reduce_s:.3f} s")
    ctx = Context(cell.traffic["driver"], setup_s, window,
                  sum(u.frames for u in window.units), spans, summary, mc)
    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    drv.release()
    if mc is not None:
        mc.calls.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers, errors = drv.numbers(window.units)
    for e in errors:
        log(f"reference: {e}")
    checked = judge.checks(numbers, cell.config["limits"])
    log(f"judged in {time.perf_counter() - t0:.3f} s")
    result = {"correct": judge.passed(checked),
              "attempted": ctx.frames,
              "failed": numbers["frames_wrong"],
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = TR.breakdown(summary, spans.intervals, OUTSIDE)
    result["checks"] = checked
    return result
