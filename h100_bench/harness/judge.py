"""What decides `correct`: the outputs of the timed path against the
plain reference (`plainref/`, numpy, no package of the repository).

Decode: the input is one fixed stream, so every stream the window
decoded is held whole to the reference's output for it, which the
configuration states (`c_oracle_output_sha256`: the C reference
decoder's; `tests/test_h100bench_plainref.py` holds the plain reference
to it).  Encode: every clip the window coded.  The reference decodes
the clip's stream; each frame must equal the encoder's reconstruction,
and the reference's decode is held against the source clip and the
stream's size, so a self-consistent stream that codes the clip worse
(more skips, no motion, no CLPF) fails too.  Each number has its limit
in the configuration file (`limits`); the run is correct when every
number is at or under its limit.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import subprocess
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REFERENCE_WORKERS = 4
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the numbers of one clip that are not summed over clips: the window's
# worst clip is the number
WORST = ("luma_mse", "bits_per_pixel", "clpf_off_frames")
MAX_MSE = 255.0 ** 2


def sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def decode_numbers(streams, frames: int, oracle_sha256: str) -> dict:
    """streams: the frame lists (display order) of every stream decoded,
    each of a stream of `frames` frames.  A stream whose frames, joined,
    differ from the reference's output counts all its frames wrong (and
    any extra ones)."""
    wrong = 0
    for got in streams:
        if len(got) != frames or sha256(b"".join(got)) != oracle_sha256:
            wrong += max(frames, len(got))
    return {"frames_wrong": wrong}


def reference_frames(stream: bytes, skip_deblock: bool = False,
                     clpf_log=None):
    """The plain reference's decode of a stream, in display order; with
    skip_deblock the deblocking filter is left out (the control, which
    breaks the guarantee of a normative decode).  clpf_log, a list, gets
    each frame's coded CLPF strengths."""
    from plainref import decoder as ref

    def decode():
        out = dict(ref.decode_frames(stream, clpf_log))
        return [out[k] for k in sorted(out)]
    if not skip_deblock:
        return decode()
    f = ref.filters
    saved = f.deblock_frame_y, f.deblock_frame_uv
    f.deblock_frame_y = lambda *a, **k: None
    f.deblock_frame_uv = lambda *a, **k: None
    try:
        return decode()
    finally:
        f.deblock_frame_y, f.deblock_frame_uv = saved


def clip_numbers(stream: bytes, recon: bytes, source: bytes, width: int,
                 height: int, frames: int, recon_from_reference=False):
    """(numbers, error) of one coded clip.
    - frames_wrong: frames where the reference's decode of the stream
      and the reconstruction differ, or either lacks it, or that are
      one more than the clip has; a stream the reference cannot decode
      carries no frame;
    - luma_mse: the mean over the clip's frames of the luma's squared
      error, the reference's decode against the source (a frame it
      lacks counts 255 squared);
    - bits_per_pixel: the stream's bits over the clip's luma pixels;
    - clpf_off_frames: frames whose stream codes CLPF strength 0 in
      every plane (or none at all).
    With recon_from_reference the encoder's reconstruction is replaced
    by the reference's decode without its deblocking filter (the
    control)."""
    error = None
    log = []
    try:
        dec = reference_frames(stream, clpf_log=log)
    except Exception:  # noqa: BLE001 - any failure of the reference on
        # this stream is a stream that carries no frame; named below
        dec, error = [], traceback.format_exc(limit=3)
    if recon_from_reference:
        recon = b"".join(reference_frames(stream, skip_deblock=True))
    fsize = width * height * 3 // 2
    rec = [recon[o:o + fsize] for o in range(0, len(recon), fsize)]
    wrong = sum(1 for i in range(max(frames, len(dec), len(rec)))
                if i >= frames or i >= len(dec) or i >= len(rec)
                or dec[i] != rec[i])
    npix = width * height
    src = np.frombuffer(source, np.uint8)
    sq = 0.0
    for i in range(frames):
        if i < len(dec):
            d = (np.frombuffer(dec[i], np.uint8, npix).astype(np.int64)
                 - src[i * fsize:i * fsize + npix])
            sq += float(np.mean(d * d))
        else:
            sq += MAX_MSE
    off = sum(1 for i in range(frames)
              if i >= len(log) or not log[i] or not any(log[i]))
    return {"frames_wrong": wrong, "luma_mse": sq / frames,
            "bits_per_pixel": 8.0 * len(stream) / (npix * frames),
            "clpf_off_frames": off}, error


def _clip_job(job):
    return clip_numbers(*job)


def worker_main():
    """A worker process: the pickled list of jobs on standard input, the
    pickled list of their (numbers, error) on standard output."""
    jobs = pickle.load(sys.stdin.buffer)
    out = sys.stdout.buffer
    sys.stdout = sys.stderr   # only the pickle goes to the pipe
    pickle.dump([_clip_job(j) for j in jobs], out)
    out.flush()


WORKER = ["-c", f"import sys; sys.path[:0] = [{BENCH_DIR!r}]; "
          "from harness.judge import worker_main; worker_main()"]


def in_workers(jobs, n):
    """The (numbers, error) of every job, in order, from `n` worker
    processes, each a fresh interpreter given every n-th job.  Every
    worker has ended, and been waited for, when this returns or raises:
    a pool of multiprocessing's would leave its resource tracker
    running until this process exits."""
    shares = [list(range(w, len(jobs), n)) for w in range(n)]
    procs = []
    try:
        for _ in shares:
            procs.append(subprocess.Popen([sys.executable, *WORKER],
                                          stdin=subprocess.PIPE,
                                          stdout=subprocess.PIPE))
        with ThreadPoolExecutor(n) as ex:
            outs = list(ex.map(
                lambda p, share: p.communicate(
                    pickle.dumps([jobs[i] for i in share]))[0],
                procs, shares))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = [None] * len(jobs)
    for p, share, out in zip(procs, shares, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a reference worker exited {p.returncode}")
        for i, r in zip(share, pickle.loads(out)):
            results[i] = r
    return results


def encode_numbers(jobs):
    """jobs: (stream, recon, source, width, height, frames,
    recon_from_reference) per clip.  Returns (numbers over all clips,
    errors).  Several clips are judged in worker processes."""
    if len(jobs) == 1:
        results = [_clip_job(j) for j in jobs]
    else:
        results = in_workers(jobs, min(REFERENCE_WORKERS, len(jobs)))
    total = {"frames_wrong": 0}
    errors = []
    for numbers, err in results:
        for k, v in numbers.items():
            total[k] = (max(total.get(k, v), v) if k in WORST
                        else total[k] + v)
        if err:
            errors.append(err)
    return total, errors


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited number, in the order
    of the limits."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
