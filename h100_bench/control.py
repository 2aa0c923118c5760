#!/usr/bin/env python3
"""The control of a cell (see harness/control.py): the plain reference
with its deblocking filter left out, put in the program's place, judged
as a run judges; or, with --fault, the port with a fault of
harness/faults.py planted.  It must print "correct": false for every
seed.

    python3 h100_bench/control.py --workload NAME --seeds 11,12,13
    python3 h100_bench/control.py --workload enc360_ldblc_turbo \
        --seeds 11,12,13 --clips 1 --fault all_skip

run from the root of a checkout, on the card (the encode cell encodes
its clips with the port first).  One JSON line a seed.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    p = argparse.ArgumentParser(prog="h100_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--clips", type=int, default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    from harness import cli, control, manifest
    os.environ.update(cli.cache_dirs(manifest.ROOT))
    cell = manifest.cell(manifest.load(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control.run(cell, seed, clips=args.clips,
                                     fault=args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    sys.exit(main())
