"""The plain reference decodes the C oracle's goldens to the C reference
decoder's output, and the 1080p stream to its sha256."""
import glob
import hashlib
import os

import pytest

from h100bench_util import BENCH_DIR, ROOT, TINY64_REC_SHA256
from harness import manifest
from plainref import decoder

GOLDEN = os.path.join(ROOT, "tests", "golden")
NAMES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(GOLDEN, "*.bit")))


def test_tiny64_is_the_c_oracles_output():
    with open(os.path.join(BENCH_DIR, "data", "tiny64_ldblc.bit"), "rb") as f:
        frames = decoder.decode_stream(f.read())
    with open(os.path.join(GOLDEN, "tiny64_ldblc_rec.yuv"), "rb") as f:
        assert b"".join(frames) == f.read()
    assert hashlib.sha256(b"".join(frames)).hexdigest() == TINY64_REC_SHA256


@pytest.mark.parametrize("name", NAMES)
def test_every_golden(name):
    with open(os.path.join(GOLDEN, name + ".bit"), "rb") as f:
        frames = decoder.decode_stream(f.read())
    with open(os.path.join(GOLDEN, name + "_rec.yuv"), "rb") as f:
        assert b"".join(frames) == f.read()


def test_1080p_stream_is_the_c_oracles_output():
    cfg = manifest.cell(manifest.load(), "dec1080_ldblc_1s").config
    with open(os.path.join(BENCH_DIR, cfg["input"]["stream"]), "rb") as f:
        frames = decoder.decode_stream(f.read())
    assert len(frames) == cfg["codec"]["frames_per_stream"]
    assert (hashlib.sha256(b"".join(frames)).hexdigest()
            == cfg["input"]["c_oracle_output_sha256"])


def test_a_corrupted_stream_raises():
    with open(os.path.join(BENCH_DIR, "data", "tiny64_ldblc.bit"), "rb") as f:
        data = bytearray(f.read())
    data[40] ^= 0xFF
    with pytest.raises(Exception):
        decoder.decode_stream(bytes(data))


def test_imports_no_package_of_the_repository():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); import plainref.decoder; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'torch', 'thor_tpu', 'thor_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % BENCH_DIR)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=BENCH_DIR)
    assert r.returncode == 0, r.stdout + r.stderr
