"""thor_tpu_torch's exact host-RDO encoder against the reference Thorenc,
byte for byte, on the CPU: the 13 configurations of
tests/test_encoder_golden.py (its clips, configs and marks), each stream
and recon equal to tests/golden/<name>.bit and <name>_rec.yuv.

Six of the eight tier-1 cases are here; hdb9_128 and ir2_128 (the two
longest) are in test_torch_encoder_golden_b.py, so that `--dist
loadfile` runs the two halves on two workers.  The two `veryslow` cases
(about 100 s each on one CPU) are marked `slow` too, so that a run
that selects `-m 'not slow'` (which replaces pytest.ini's default
selection) leaves them out as the default selection does; `-m
veryslow` runs them.  `_check` is the
contract of thor_tpu's `_check`, on the port's encode_sequence with the
CPU as its device.
"""
import os

import pytest
import torch

from conftest import (make_c444, make_hbd12, make_hdb9, make_noise_cif,
                      make_small256, make_smooth_cif, make_tiny64)
from thor_tpu_torch.enc import encode_sequence, parse_config_file
from thor_tpu_torch.enc.params import EncParams, apply_args

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def golden(name):
    with open(os.path.join(GOLDEN, name + ".bit"), "rb") as f:
        bits = f.read()
    with open(os.path.join(GOLDEN, name + "_rec.yuv"), "rb") as f:
        return bits, f.read()


def golden_params(w, h, n, cfg="LDB_low_complexity", **overrides):
    """thor_tpu's golden parameters: a config file of tests/golden with
    the clip's geometry, QP 32 and 30 Hz."""
    return parse_config_file(os.path.join(GOLDEN, f"config_{cfg}.txt"),
                             width=w, height=h, num_frames=n, qp=32,
                             frame_rate=30.0, **overrides)


def _check(name, yuv, w, h, n, cfg="LDB_low_complexity", **overrides):
    bits, recon = encode_sequence(golden_params(w, h, n, cfg, **overrides),
                                  yuv, device="cpu")
    ref, rr = golden(name)
    assert bits == ref, "bitstream mismatch"
    assert recon == rr, "recon mismatch"


def test_encode_tiny64_ldb_low_complexity():
    _check("tiny64_ldblc", make_tiny64(6), 64, 64, 6)


@pytest.mark.slow
def test_encode_smooth_cif_ldb_low_complexity():
    _check("smooth_cif_ldblc", make_smooth_cif(10), 352, 288, 10)


@pytest.mark.slow
def test_encode_noise_cif_ldb_low_complexity():
    _check("noise_cif_ldblc", make_noise_cif(4), 352, 288, 4)


def test_encode_hbd_10bit():
    _check("hbd6_128", make_hdb9(9), 128, 96, 6, bitdepth=10)


def test_encode_max_delta_qp():
    _check("tiny64_dqp", make_tiny64(6), 64, 64, 4, max_delta_qp=1)


def test_encode_rate_control():
    _check("tiny64_rc", make_tiny64(6), 64, 64, 6, bitrate=200000)


@pytest.mark.slow
@pytest.mark.veryslow
def test_encode_ldb_high_efficiency():
    _check("he2_256", make_small256(2), 256, 192, 2,
           cfg="LDB_high_efficiency")


@pytest.mark.slow
@pytest.mark.veryslow
def test_encode_ra_medium():
    _check("ra9_256", make_small256(9), 256, 192, 9,
           cfg="RA_medium_complexity")


def test_encode_444():
    _check("c444_128", make_c444(4), 128, 96, 4, subsample=444)


def test_encode_sync():
    _check("sync4_128", make_hdb9(9), 128, 96, 4, sync=1, encoder_speed=2)


@pytest.mark.slow
def test_encode_hbd_12bit():
    """12-bit HBD end to end (defaults + -cdef 0, as thor_tpu's test)."""
    p = EncParams()
    apply_args(p, ["-width", "128", "-height", "96", "-n", "6", "-qp", "32",
                   "-f", "30", "-input_bitdepth", "12", "-bitdepth", "12",
                   "-cdef", "0"])
    p.validate()
    bits, recon = encode_sequence(p, make_hbd12(6), device="cpu")
    ref, rr = golden("hbd12_128")
    assert bits == ref
    assert recon == rr
