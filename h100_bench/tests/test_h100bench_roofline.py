"""The frozen roofline arithmetic equals chip_smoke.py's on seeded
cells, and the MC recorder sees every call with the cells it got."""
import pytest
import torch

from h100bench_util import ROOT  # noqa: F401 - puts the harness on the path
from harness import roofline

chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("luma,planes", [(True, 1), (False, 1), (False, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7])
def test_bound_equals_chip_smokes(luma, planes, seed):
    gen = torch.Generator().manual_seed(seed)
    H, W, pad = 64, 96, 80 if luma else 40
    cells = chip_smoke.main_path_cells(gen, H, W, 4 if luma else 2, pad,
                                       luma, "cpu")
    if not luma:
        cells.pop("fs", None)
    shape = (2, (H >> (not luma)) + 2 * pad, (W >> (not luma)) + 2 * pad)
    stack = torch.zeros(shape, dtype=torch.int16)
    want = chip_smoke.bound(cells, stack, luma, planes)
    got = roofline.bound(cells, shape, stack.device, luma, planes)
    assert got == want
    assert got[0] > 0


def test_recorder_sees_each_entry_point_once_per_call():
    rec = roofline.McCalls()
    calls = []

    def fake_luma(ref_stack, rsel, y0, x0, op, vf, hf, fs, cs, bitdepth):
        calls.append("luma")

    def fake_uv(u_stack, v_stack, rsel, y0, x0, op, vf, hf, cs, bitdepth):
        calls.append("uv")

    class Dev:      # stands for a CUDA tensor's device
        type = "cuda"

    class Stack:
        shape = (2, 8, 8)
        device = Dev()

    cell = torch.zeros(3, dtype=torch.int32)
    luma = rec._wrap(fake_luma, True, 1)
    uv = rec._wrap(fake_uv, False, 2)
    luma(Stack(), cell, cell, cell, cell, cell, cell, cell, 4, 8)
    uv(Stack(), Stack(), cell, y0=cell, x0=cell, op=cell, vf=cell, hf=cell,
       cs=2, bitdepth=8)
    assert calls == ["luma", "uv"]
    assert [(c.luma, c.planes, len(c.cells)) for c in rec.calls] == [
        (True, 1, 7), (False, 2, 6)]
