"""The two longest tier-1 golden encodes of test_torch_encoder_golden.py
(B frames over HDB low complexity; with interp_ref=2), in a file of their
own so that `--dist loadfile` runs them beside the other six."""
from conftest import make_hdb9
from test_torch_encoder_golden import _check


def test_encode_hdb_bframes():
    _check("hdb9_128", make_hdb9(9), 128, 96, 9, cfg="HDB_low_complexity")


def test_encode_interp_ref2():
    _check("ir2_128", make_hdb9(9), 128, 96, 9, cfg="HDB_low_complexity",
           interp_ref=2)
