"""The control of a cell, and the faults planted in the program: each
has to come out not correct.

The control is the plain reference, with one guarantee that the
configuration states broken, put in the program's place.  The
configurations state no precision (the codec's arithmetic is exact
integer), so the control breaks the guarantee of a normative decode:
the reference leaves out its deblocking filter, the stage a faster loop
filter would be tempted to approximate.  Decode cell: that decode of
the cell's stream stands in for the window's stream.  Encode cell: the
port encodes the seed's clips on the card, as a run's window does, and
that decode of each clip's stream stands in for the encoder's
reconstruction; the port's own numbers on the same clips are printed
beside it.

A fault (`faults.FAULTS`, encode cell) is planted in the port while it
encodes the seed's clips, and the port's numbers are judged as a run
judges them.  The benchmark's runs never run either: `control.py` does.
"""
from __future__ import annotations

from . import drivers, faults, judge
from .spans import patched


def run(cell, seed, device=None, clips=None, fault=None):
    drv = drivers.make(cell, seed, device)
    out = {"workload": cell.name, "seed": seed}
    if isinstance(drv, drivers.DecodeDriver):
        if fault is not None:
            raise ValueError("faults are planted in the encoder")
        inp = cell.config["input"]
        data = drivers.read_checked(cell, inp["stream"], inp["stream_sha256"])
        frames = judge.reference_frames(data, skip_deblock=True)
        n = cell.config["codec"]["frames_per_stream"]
        numbers, _ = drv.numbers([drivers.Unit(n, [frames])])
        out["control"] = numbers
    else:
        drv.setup()
        with patched(faults.FAULTS[fault] if fault else []):
            units = [drv.run_unit(i)
                     for i in range(clips or len(drv.clips))]
        out["program"], _ = judge.encode_numbers(drv.jobs(units))
        if fault is None:
            numbers, _ = judge.encode_numbers(
                drv.jobs(units, recon_from_reference=True))
            out["control"] = numbers
        else:
            numbers = out["program"]
            out["fault"] = fault
    out["checks"] = judge.checks(numbers, cell.config["limits"])
    out["correct"] = judge.passed(out["checks"])
    return out
