"""The run's guards: the whole-name check for JAX and the JAX package,
no result without a card, and nothing but the benchmark's files is not
enough to run."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench_util import BENCH_DIR, ROOT
from harness import cli


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "thor_tpu", "thor_tpu.dec.decoder", "thor_tpu_torch",
             "thor_tpu_torch.dec", "jaxtyping", "numpy", "harness"]
    assert cli.forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                            "thor_tpu"]
    assert cli.forbidden_modules(["thor_tpu_torch.enc", "torch"]) == []


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "dec1080_ldblc_1s", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = _run(ROOT)
    assert r.returncode == 2
    assert r.stdout == ""
    assert "no CUDA card" in r.stderr


def test_the_benchmarks_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""


def test_cards_missing():
    class Cuda:
        def __init__(self, avail, n):
            self.avail, self.n = avail, n

        def is_available(self):
            return self.avail

        def device_count(self):
            return self.n

    class T:
        def __init__(self, avail, n):
            self.cuda = Cuda(avail, n)

    assert "no CUDA card" in cli.cards_missing(T(False, 0), 1)
    assert "asks for 4" in cli.cards_missing(T(True, 1), 4)
    assert cli.cards_missing(T(True, 4), 4) is None


def test_caches_stay_in_the_checkout():
    for path in cli.cache_dirs(ROOT).values():
        assert path.startswith(os.path.join(ROOT, "build", ""))
