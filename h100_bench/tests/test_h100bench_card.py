"""On the card: one short run of every cell through run.py, as the
benchmark is run, must print a correct result line.  Skips without a
CUDA card (decided in the fixture)."""
import json
import subprocess
import sys

import pytest

from h100bench_util import ROOT
from harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    r = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 41), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
