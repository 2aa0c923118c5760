"""Shared by the benchmark's tests: the harness on sys.path, and the two
cells cut to sizes a CPU test holds (the real cells' names, so the
manifest's metrics apply; the configuration and traffic shrunk)."""
import copy
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import manifest  # noqa: E402

TINY64_REC_SHA256 = ("a4cb3bb5585e988d8ef55f47989f65a96ea035d7"
                     "0995a9809794c6a884fc1edc")
SEED = 2 ** 31 + 12345   # a run's seeds may exceed 32 signed bits


def tiny_decode_cell():
    """dec1080_ldblc_1s on the 64x64 6-frame C-oracle stream (its
    warm-up stream) in place of the 1080p one."""
    bench = manifest.load()
    cell = manifest.cell(bench, "dec1080_ldblc_1s")
    cfg = copy.deepcopy(cell.config)
    inp = cfg["input"]
    inp["stream"] = inp["warmup_stream"]
    inp["stream_sha256"] = inp["warmup_stream_sha256"]
    inp["c_oracle_output_sha256"] = TINY64_REC_SHA256
    cfg["codec"].update(width=64, height=64, frames_per_stream=6)
    return bench, manifest.Cell(cell.name, cell.chips, cfg, cell.traffic)


def tiny_encode_cell(frames=2):
    """enc360_ldblc_turbo on 64x64 clips of `frames` frames, one warm-up
    frame, two clips in the pool.  Its clips code to more bits a pixel
    than the cell's limit: judge it by frames_wrong."""
    bench = manifest.load()
    cell = manifest.cell(bench, "enc360_ldblc_turbo")
    cfg = copy.deepcopy(cell.config)
    cfg["codec"].update(width=64, height=64, frames_per_clip=frames)
    tr = copy.deepcopy(cell.traffic)
    tr.update(warmup_frames=1, clips_in_pool=2)
    return bench, manifest.Cell(cell.name, cell.chips, cfg, tr)


def one_clip_encode_cell():
    """enc360_ldblc_turbo at its own size (one 8-frame 640x360 clip a
    window, where the configuration's limits hold), one warm-up frame."""
    bench = manifest.load()
    cell = manifest.cell(bench, "enc360_ldblc_turbo")
    tr = copy.deepcopy(cell.traffic)
    tr.update(warmup_frames=1, clips_in_pool=1)
    return bench, manifest.Cell(cell.name, cell.chips, cell.config, tr)
