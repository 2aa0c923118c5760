"""The judge's worker processes give the numbers that judging in this
process gives, and none of them, nor any helper, outlives the call."""
import glob
import os

from h100bench_util import BENCH_DIR
from harness import judge


def children():
    pids = set()
    for f in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(f) as fh:
            pids.update(fh.read().split())
    return pids


def tiny_jobs():
    """Three 64x64 clips: the 6-frame C-oracle stream with the
    reference's decode as source and recon, then altered ones."""
    with open(os.path.join(BENCH_DIR, "data", "tiny64_ldblc.bit"), "rb") as f:
        stream = f.read()
    dec = b"".join(judge.reference_frames(stream))
    bad = bytes([dec[0] ^ 1]) + dec[1:]
    return [(stream, dec, dec, 64, 64, 6, False),
            (stream, bad, dec, 64, 64, 6, False),
            (stream, dec, bad, 64, 64, 6, False)]


def test_workers_match_this_process_and_leave_nothing_running():
    jobs = tiny_jobs()
    before = children()
    got = judge.in_workers(jobs, 2)
    assert children() == before
    assert got == [judge.clip_numbers(*j) for j in jobs]
    assert [n["frames_wrong"] for n, _ in got] == [0, 1, 0]
    total, errors = judge.encode_numbers(jobs)
    assert children() == before
    assert total["frames_wrong"] == 1 and errors == []
