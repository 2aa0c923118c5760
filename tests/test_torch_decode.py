"""The port's decode end to end: thor_tpu_torch.decode_stream on the CPU
against the C-oracle goldens (the same outputs tests/test_decoder_golden.py
holds the JAX decoder to): all 19 of them, on the fused route and off it,
without JAX, and through the CLI."""
import glob
import hashlib
import os
import re
import subprocess
import sys

import pytest
import torch

from thor_tpu_torch import decode_stream
from thor_tpu_torch import trace as TR
from thor_tpu_torch.dec import decoder as PD
from thor_tpu_torch.dec import device_frame as PDF

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _check(name, fused=True, routes=None):
    """Decodes a golden byte for byte; `routes` names the routes its
    frames must take (all fused unless said otherwise)."""
    golden = _read(name + "_rec.yuv")
    TR.reset(*PD.ROUTE_COUNTERS)
    was = TR.enabled()
    TR.drain()
    TR.enable()
    try:
        _, frames = decode_stream(_read(name + ".bit"), device="cpu",
                                  fused=fused)
    finally:
        TR.enable(was)
    runs = sum(r.name == "dec.device_frame" for r in TR.drain())
    took = {k: v for k, v in PD.route_frames().items() if v}
    assert sum(took.values()) == len(frames)
    assert runs == took.get("fused", 0)
    assert set(took) == set(routes or ["fused"]), took
    fs = len(golden) // len(frames)
    assert len(golden) == fs * len(frames)
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


@pytest.mark.parametrize("name", [
    "hdb9_128", "ir2_128", "ra9_256", "s17_RA_medium_complexity",
    "s17_HDB16_low_complexity"])
def test_interp_ref_goldens(name):
    """B-frame streams (HDB and RA) whose frames predict from a
    temporally interpolated reference: interp_ref 1, and 2 (ir2_128,
    which also stores the MVs for the temporal candidates)."""
    _check(name)


def test_qmtx_golden():
    """Weighted dequantization (qmtx=1)."""
    _check("small256_LDB_qm_medium_complexity")


@pytest.mark.parametrize("name,why", [
    ("c444_128", "subsample=466"),
    ("s17_hbd10", "tb-split intra"),
    ("small256_LDB_high_efficiency", "tb-split intra")])
def test_refuses_streams_outside_the_slice(name, why):
    """The three streams that the port refused while it had the fused
    route alone (`why` says what took them off it) decode byte for byte
    on the unfused routes: 4:4:4 on the host records, tb-split intra on
    the two-stage executor, and with qmtx (s17_hbd10) on the host records
    again."""
    routes = {"c444_128": ["host_records"], "s17_hbd10": ["host_records"],
              "small256_LDB_high_efficiency": ["two_stage", "host_records"]}
    _check(name, routes=routes[name])


@pytest.mark.parametrize("name", [
    "hbd6_128", "he2_256", "noise_cif_ldblc", "smooth_cif_ldblc",
    "small256_LDB_medium_complexity", "tiny64_dqp", "tiny64_rc"])
def test_remaining_goldens(name):
    """With the tests above, all 19 streams of tests/golden/ decode."""
    _check(name, routes=["two_stage", "host_records"] if name == "he2_256"
           else None)


def test_every_golden_has_a_decode_test():
    with open(__file__) as f:
        src = f.read()
    names = sorted(os.path.basename(p)[:-4]
                   for p in glob.glob(os.path.join(GOLDEN, "*.bit")))
    assert len(names) == 19
    assert [n for n in names if f'"{n}"' not in src] == []


@pytest.mark.parametrize("name,ring_cap", [
    ("tiny64_ldblc", 34), ("sync4_128", 1),
    ("small256_LDB_medium_complexity", 34),
    ("small256_LDB_qm_medium_complexity", 34)])
def test_unfused_routes_equal_fused(name, ring_cap, monkeypatch):
    """fused=False sends every frame to the two-stage executor (P and B
    frames) or the host records (I frames; every frame of a qmtx stream),
    as THOR_DEVICE_FRAME=0 does in thor_tpu: the same bytes."""
    monkeypatch.setattr(PDF.DeviceFrameDecoder, "RING_CAP", ring_cap)
    qm = "_qm_" in name
    _check(name, fused=False,
           routes=["host_records"] if qm else ["two_stage", "host_records"])


def test_no_refusal_names_the_decoder_fallbacks():
    """Nothing in the package raises NotImplementedError for ROADMAP
    item 7 (the decoder's unfused routes) any more."""
    for src in glob.glob(os.path.join(REPO, "thor_tpu_torch", "**", "*.py"),
                         recursive=True):
        with open(src) as f:
            text = f.read()
        assert "item 7" not in text, src
        if os.path.basename(os.path.dirname(src)) == "dec":
            assert "NotImplementedError" not in text, src


def test_package_never_imports_jax():
    """No import of jax, thor_tpu or bench.py, no loader alias of
    thor_tpu's files and no path built onto the thor_tpu directory."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|thor_tpu|bench)\b"
                     r"|_thor_tpu_host|[\"']thor_tpu[\"']"
                     r"|join\([^)]*[\"']thor_tpu/", re.M)
    srcs = glob.glob(os.path.join(REPO, "thor_tpu_torch", "**", "*.py"),
                     recursive=True)
    assert srcs
    # the encoder's modules are among them
    for mod in ("encoder", "turbo", "turbo_final", "turbo_native",
                "filters_rdo", "params", "writer", "me", "rc", "device_lc",
                "gop_lanes", "multistream"):
        assert os.path.join(REPO, "thor_tpu_torch", "enc", mod + ".py") \
            in srcs, mod
    for mod in ("ops/enc_kernels.py", "dec/multistream.py"):
        assert os.path.join(REPO, "thor_tpu_torch", mod) in srcs, mod
    for src in srcs + [os.path.join(REPO, "chip_smoke.py"),
                       os.path.join(REPO, "tests", "test_torch_cuda.py")]:
        with open(src) as f:
            assert not pat.search(f.read()), src


def test_decodes_without_jax(tmp_path):
    """A process where `import jax` fails decodes tiny64_ldblc, ir2_128
    (temporal interpolation) and small256_LDB_high_efficiency (the
    two-stage executor, the host records and the unfused loop filters)
    exactly, imports the tile pipeline, its entry, the qmtx tables and
    the multi-stream modules, never loads the real thor_tpu package nor
    any file under thor_tpu/ (no `_thor_tpu_host` alias either), and
    builds its C host tier from thor_tpu_torch/_native."""
    code = (
        "import os, sys, hashlib\n"
        "sys.modules['jax'] = None\n"
        "import thor_tpu_torch, thor_tpu_torch.entry, thor_tpu_torch.qmtx\n"
        "import thor_tpu_torch.models.pipeline\n"
        "import thor_tpu_torch.dec.multistream\n"
        "import thor_tpu_torch.enc.gop_lanes, thor_tpu_torch.enc.multistream\n"
        "fr = [b''.join(thor_tpu_torch.decode_stream(open(p, 'rb').read(),"
        " device='cpu')[1]) for p in sys.argv[1:]]\n"
        "ref = os.path.join(os.getcwd(), 'thor_tpu') + os.sep\n"
        "bad = [m for m, mod in list(sys.modules.items()) if m == 'thor_tpu'"
        " or m.startswith(('thor_tpu.', 'jax.', '_thor_tpu_host'))"
        " or (getattr(mod, '__file__', None) or '').startswith(ref)]\n"
        "from thor_tpu_torch import _native\n"
        "port = os.path.join(os.getcwd(), 'thor_tpu_torch', '_native')\n"
        "bad += [s for s in _native._SRCS if os.path.dirname(s) != port]\n"
        "print(*[hashlib.sha256(f).hexdigest() for f in fr], bad)\n")
    # one torch thread, as in the test processes: beside other test
    # processes a pool of one thread per core spins for minutes
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    names = ("tiny64_ldblc", "ir2_128", "small256_LDB_high_efficiency")
    r = subprocess.run([sys.executable, "-c", code] +
                       [os.path.join(GOLDEN, n + ".bit") for n in names],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    want = [hashlib.sha256(_read(n + "_rec.yuv")).hexdigest() for n in names]
    assert r.stdout.split() == want + ["[]"]


def _cli_dec(name, out):
    r = subprocess.run([sys.executable, "-m", "thor_tpu_torch.cli", "dec",
                        os.path.join(GOLDEN, name + ".bit"), str(out)],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=600,
                       env={**os.environ, "THOR_TORCH_DEVICE": "cpu",
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    with open(os.path.join(GOLDEN, "stdout", name + "_dec.txt")) as f:
        assert r.stdout == f.read()
    assert out.read_bytes() == _read(name + "_rec.yuv")


def test_cli_dec(tmp_path):
    """python -m thor_tpu_torch.cli dec: Thordec's stdout, golden YUV
    (on the CPU, which THOR_TORCH_DEVICE asks for)."""
    _cli_dec("tiny64_ldblc", tmp_path / "out.yuv")


def test_cli_dec_444(tmp_path):
    """A 4:4:4 stream (host records, unfused loop filters): the
    statistics report equals Thordec's too."""
    _cli_dec("c444_128", tmp_path / "out.yuv")


def test_smoke_keeps_the_bench_stream_and_its_hash():
    """chip_smoke.py holds the bench stream's path and sha256 itself (it
    imports nothing of bench.py); both equal bench.py's."""
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke
    assert chip_smoke.BENCH_REC_SHA256 == bench.REC_SHA256
    assert os.path.samefile(chip_smoke.BENCH_STREAM, bench.STREAM)


@pytest.mark.slow
def test_bench_stream_1080p():
    """The main path: the 1080p LDB-LC bench stream hashes to bench.py's
    REC_SHA256."""
    sys.path.insert(0, REPO)
    import bench
    with open(bench.STREAM, "rb") as f:
        _, frames = decode_stream(f.read(), device="cpu")
    assert hashlib.sha256(b"".join(frames)).hexdigest() == bench.REC_SHA256
