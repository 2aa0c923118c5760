"""The control (the plain reference without its deblocking filter in the
program's place) comes out not correct, at sizes a test holds; on the
card, control.py runs it at the cells' own sizes."""
from h100bench_util import SEED, tiny_decode_cell, tiny_encode_cell
from harness import control


def test_decode_control_is_not_correct():
    _, cell = tiny_decode_cell()
    r = control.run(cell, SEED, device="cpu")
    assert r["correct"] is False
    assert r["control"]["frames_wrong"] == 6


def test_encode_control_is_not_correct_and_the_program_is(tmp_path):
    _, cell = tiny_encode_cell(frames=3)
    r = control.run(cell, SEED, device="cpu", clips=1)
    assert r["program"]["frames_wrong"] == 0
    assert r["correct"] is False
    assert r["control"]["frames_wrong"] > 0
