"""Decoder command line of the port, compatible with Thordec.

Usage:
  python -m thor_tpu_torch.cli dec str.bit out.yuv

thor_tpu's `main_dec` (statistics on stdout as Thordec prints them)
running on the port's decode_stream: CUDA when torch sees a card, else
the CPU.
"""
from __future__ import annotations

import importlib
import sys

from . import _host


def main_dec(argv):
    cli = importlib.import_module(f"{_host.ALIAS}.cli")
    return cli.main_dec(argv)


def main():
    if len(sys.argv) < 4 or sys.argv[1] != "dec":
        print(__doc__)
        return 2
    return main_dec(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
