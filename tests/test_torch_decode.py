"""The port's decode end to end: thor_tpu_torch.decode_stream on the CPU
against the C-oracle goldens (the same outputs tests/test_decoder_golden.py
holds the JAX decoder to), without JAX, through the CLI, and its
refusals of streams outside the ported slice."""
import glob
import hashlib
import os
import re
import subprocess
import sys

import pytest
import torch

from thor_tpu_torch import decode_stream
from thor_tpu_torch.dec import device_frame as PDF

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _check(name):
    golden = _read(name + "_rec.yuv")
    PDF.RUNS = 0
    _, frames = decode_stream(_read(name + ".bit"), device="cpu")
    assert PDF.RUNS == len(frames), "a frame left the port's device path"
    fs = len(golden) // len(frames)
    for i, f in enumerate(frames):
        assert f == golden[i * fs:(i + 1) * fs], f"frame {i} mismatch"


def test_tiny64_ldblc_golden():
    _check("tiny64_ldblc")


def test_tiny64_ldblc_ring_cap_1(monkeypatch):
    """A one-entry resident ring: every frame misses the ring for its
    second reference and uploads it again from the host copy."""
    misses = []
    orig = PDF.DeviceFrameDecoder._ref_planes

    def spy(self, dec, r):
        misses.append(r.frame_num not in self.ring)
        return orig(self, dec, r)

    monkeypatch.setattr(PDF.DeviceFrameDecoder, "RING_CAP", 1)
    monkeypatch.setattr(PDF.DeviceFrameDecoder, "_ref_planes", spy)
    _check("tiny64_ldblc")
    assert sum(misses) >= 3


@pytest.mark.parametrize("name", ["hbd12_128", "sync4_128"])
def test_more_goldens(name):
    """12-bit samples, and a stream with sync frames."""
    _check(name)


@pytest.mark.parametrize("name,why", [
    ("c444_128", "subsample=466"),
    ("hdb9_128", "interp_ref=1"),
    ("small256_LDB_high_efficiency", "tb-split intra")])
def test_refuses_streams_outside_the_slice(name, why):
    PDF.RUNS = 0
    with pytest.raises(NotImplementedError, match=why):
        decode_stream(_read(name + ".bit"), device="cpu")
    if why != "tb-split intra":
        assert PDF.RUNS == 0


def test_package_never_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|thor_tpu)\b", re.M)
    srcs = glob.glob(os.path.join(REPO, "thor_tpu_torch", "**", "*.py"),
                     recursive=True)
    assert srcs
    for src in srcs + [os.path.join(REPO, "chip_smoke.py")]:
        with open(src) as f:
            assert not pat.search(f.read()), src


def test_decodes_without_jax(tmp_path):
    """A process where `import jax` fails decodes tiny64_ldblc exactly
    and never loads the real thor_tpu package."""
    code = (
        "import sys, hashlib\n"
        "sys.modules['jax'] = None\n"
        "import thor_tpu_torch\n"
        "_, fr = thor_tpu_torch.decode_stream(open(sys.argv[1], 'rb')"
        ".read(), device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'thor_tpu' or "
        "m.startswith(('thor_tpu.', 'jax.'))]\n"
        "print(hashlib.sha256(b''.join(fr)).hexdigest(), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(GOLDEN, "tiny64_ldblc.bit")],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    want = hashlib.sha256(_read("tiny64_ldblc_rec.yuv")).hexdigest()
    assert r.stdout.split() == [want, "[]"]


def test_cli_dec(tmp_path):
    """python -m thor_tpu_torch.cli dec: Thordec's stdout, golden YUV."""
    out = tmp_path / "out.yuv"
    r = subprocess.run([sys.executable, "-m", "thor_tpu_torch.cli", "dec",
                        os.path.join(GOLDEN, "tiny64_ldblc.bit"), str(out)],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(GOLDEN, "stdout", "tiny64_ldblc_dec.txt")) as f:
        assert r.stdout == f.read()
    assert out.read_bytes() == _read("tiny64_ldblc_rec.yuv")


@pytest.mark.slow
def test_bench_stream_1080p():
    """The main path: the 1080p LDB-LC bench stream hashes to bench.py's
    REC_SHA256."""
    sys.path.insert(0, REPO)
    import bench
    with open(bench.STREAM, "rb") as f:
        _, frames = decode_stream(f.read(), device="cpu")
    assert hashlib.sha256(b"".join(frames)).hexdigest() == bench.REC_SHA256
