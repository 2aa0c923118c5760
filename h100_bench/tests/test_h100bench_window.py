"""The whole-unit window: units start while less than `seconds` have
passed and the window ends when the last one returns."""
from h100bench_util import SEED  # noqa: F401 - puts the harness on the path
from harness.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def units_of(lengths, seconds, max_units=None):
    clock = Clock()

    def unit(i):
        clock.t += lengths[i % len(lengths)]
        return i
    return run_window(unit, seconds, max_units, clock=clock)


def test_starts_units_until_seconds_pass_and_never_cuts_one():
    w = units_of([30.0], 51)
    assert w.units == [0, 1] and w.seconds == 60.0
    w = units_of([25.0], 51)
    assert w.units == [0, 1, 2] and w.seconds == 75.0
    w = units_of([17.0], 51)      # 51 s have passed after three
    assert w.units == [0, 1, 2] and w.seconds == 51.0


def test_one_unit_always_runs():
    w = units_of([80.0], 51)
    assert w.units == [0] and w.seconds == 80.0
    assert units_of([80.0], 1e-9).units == [0]


def test_max_units_and_unit_seconds():
    w = units_of([10.0, 20.0], 51, max_units=1)
    assert w.units == [0] and w.unit_seconds == [10.0]
    w = units_of([10.0, 20.0], 51)
    assert w.unit_seconds == [10.0, 20.0, 10.0, 20.0]
    assert w.seconds == sum(w.unit_seconds)
