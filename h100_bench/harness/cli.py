"""The command line of run.py: one run of one cell, one JSON line.

Exits 2, printing no result, where torch sees no CUDA card or fewer than
the cell asks for; exits 3, printing no result, where the process has
loaded jax, jaxlib, flax or the JAX package (by whole top-level module
names: thor_tpu_torch is not thor_tpu).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "thor_tpu")


def forbidden_modules(names=None):
    """Top-level names of loaded modules that the benchmark must not load."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None
                                      else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


def cache_dirs(root):
    """Fixed cache directories inside the checkout for every compiler
    cache a library may keep (the port builds into build/thor_tpu_torch/
    by itself)."""
    base = os.path.join(root, "build", "h100_bench")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda_cache")}


def parse(argv):
    p = argparse.ArgumentParser(prog="h100_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards_missing(torch, chips: int):
    """Why this machine cannot run a cell on `chips` cards, or None."""
    if not torch.cuda.is_available():
        return "torch sees no CUDA card"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def main(argv=None) -> int:
    args = parse(argv)
    from . import manifest
    os.environ.update(cache_dirs(manifest.ROOT))
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    import torch
    why = cards_missing(torch, cell.chips)
    if why:
        print(f"h100_bench: {why}; no result", file=sys.stderr)
        return 2
    from . import runner
    result = runner.run(bench, cell, args.seed, args.seconds,
                        bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
